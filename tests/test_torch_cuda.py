"""Each CUDA kernel of the port against its plain torch version on the card,
at the main path's shapes (the checks of chip_smoke.py phase 3), the
persistent kernels (shade, surface, surface_v2, traverse) at the launch
shapes their grid-stride and ray-fetch loops must get right, sobol_block
and the per-pixel flush at small widths, isect on material_test's tables,
and the general body (torch around isect and sobol_block) on the card
against the CPU at 0, 1, 31 and 129 lanes; the tracking walks, with the
interaction walk's emissive variant on the fire path's lanes, the
general body over fire.scene, the walks' lane mapping (twice smoke's
lanes with a NaN lane among them, repeated launches, both row forms over
dense, sparse and multi-grid arenas, and the refusals of misaligned rows
and strided lanes), kernel 6 on hero.take's and portal.take's
first bounce, isect on portal.scene's tables, the filtered flush at
the Cornell path's width and at small widths in its three footprint
rules (with every finishing lane on one pixel, under both of its
mappings), the traversal over forest.take's 144 instances and its
motion-blur variant (kAnim) at seeded shutter times, the instance pick
on tables of 1 to 1,000 rows with ties in clusters of identical boxes
(static and moving), the photon
gather on caustics_photons.take's first bounce, a dense map and small
widths, with lanes at the 512-visit cap beside empty ones and lanes
whose cells repeat, the point and curve walks on sparks.take's and
hairball.take's first bounce and on as many incoherent lanes, and at
small widths and one lane past a pass of their resident grid (lanes that
do not walk, bounds short of every hit, a NaN ray, the moving arena at
shutter open and close, incoherent rays) with their refusals, sparks and hairball through the
Driver on the card against the CPU, and the lighttracer's camera splat on cornell_particles.take's
first bounce and on seeded lanes from 1 to 4,096, and at 4,096 and
262,145 lanes onto 64 pixels, onto one pixel or none connecting, with
the particle pass
on the card against the CPU. Skipped without a card. This file imports no jax, so it also runs on a
machine without the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

# lane counts of the launch-shape tests; "resident+1" is one more lane than
# one pass of the kernel's resident grid (SMs x resident blocks x 128)
SHAPES = [0, 1, 31, 129, "resident+1"]


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("kernel", ["sobol_block", "isect", "accum", "shade", "surface", "traverse",
                                    "surface_v2", "surface_v2_hero", "isect_portal",
                                    "surface_v2_portal", "accum_filtered", "traverse_forest",
                                    "traverse_anim", "points", "curves", "traverse_deform"])
def test_kernel_matches_plain_on_card(cuda_device, kernel):
    """surface_v2_hero: kernel 6 on the first bounce of a 1280x720
    hero.take render, whose roughness varies per lane across the knot;
    isect_portal: closest and any-hit over portal.scene's tables, shadow
    rays passing the shadow-invisible window and the hidden dome;
    surface_v2_portal: kernel 6 on the first bounce of a 512x384
    portal.take render (NEE candidates with the portal's windowed pdfs);
    accum_filtered: the filtered flush on Cornell 1080p's lanes, Mitchell
    r2 and Blackman r1 shuffled, unshuffled and clamped to the edge;
    traverse_forest: the walk over forest.take's 144 instances on its
    640x360 first-bounce lanes, bit-exact; traverse_anim: the motion-blur
    variant on a moving copy of the forest at seeded shutter times;
    points: the point walk on sparks.take's 640x360 first-bounce lanes,
    moving and held at shutter open, closest and any-hit, and on as many
    incoherent lanes, bit-exact; curves: the curve walk on hairball.take's
    384x384 first-bounce lanes and on as many incoherent lanes, closest and
    any-hit, bit-exact; traverse_deform: the deforming form on the 921,600
    camera lanes of a two-frame .sub trefoil-512x480 at seeded shutter
    times (0 and 1 on some lanes, a NaN ray), closest and any-hit, and
    traverse_anim_deform over a moving instance of it, bit-exact."""
    import chip_smoke

    check = {"sobol_block": chip_smoke.check_sobol, "isect": chip_smoke.check_isect,
             "accum": chip_smoke.check_accum, "shade": chip_smoke.check_shade,
             "surface": chip_smoke.check_surface, "traverse": chip_smoke.check_traverse,
             "surface_v2": chip_smoke.check_surface_v2,
             "surface_v2_hero": chip_smoke.check_surface_v2_hero,
             "isect_portal": chip_smoke.check_isect_portal,
             "surface_v2_portal": chip_smoke.check_surface_v2_portal,
             "accum_filtered": chip_smoke.check_accum_filtered,
             "traverse_forest": chip_smoke.check_traverse_forest,
             "traverse_anim": chip_smoke.check_traverse_anim,
             "points": chip_smoke.check_points, "curves": chip_smoke.check_curves,
             "traverse_deform": chip_smoke.check_traverse_deform}[kernel]
    result = check(cuda_device)  # raises on any disagreement
    for r in (result.values() if kernel == "traverse_deform" else [result]):
        assert r["ms"] > 0.0


def _lanes(shape, symbol: str) -> int:
    from zyg_tpu_torch import ops

    return ops.resident_lanes(symbol) + 1 if shape == "resident+1" else shape


@pytest.mark.parametrize("n", [0, 1, 31, 129, 513])
def test_sobol_block_launch_shapes(cuda_device, n):
    g = torch.Generator(device="cpu").manual_seed(9)
    from zyg_tpu_torch.ops.sobol_block import sobol_block, sobol_block_plain

    sample = torch.randint(-2**31, 2**31, (n,), generator=g, dtype=torch.int32).to(cuda_device)
    seed = torch.randint(-2**31, 2**31, (n,), generator=g, dtype=torch.int32).to(cuda_device)
    buf, ns = sobol_block(sample, seed)
    rbuf, rns = sobol_block_plain(sample, seed)
    torch.cuda.synchronize()
    assert torch.equal(buf.view(torch.int32), rbuf.view(torch.int32)) and torch.equal(ns, rns)


@pytest.mark.parametrize("n", [0, 1, 31, 129])
def test_accum_small_widths(cuda_device, n):
    """A few lanes flushing into a 64-pixel framebuffer, several on one pixel."""
    import chip_smoke
    from zyg_tpu_torch.ops.accum import flush_pixels, flush_plain

    pid, was_alive, alive, *planes = chip_smoke._flush_lanes(max(n, 1), 0.5, cuda_device)
    lanes = [pid[:n] % 64, was_alive[:n], alive[:n]] + [p[:n] for p in planes]
    fb0 = torch.rand((64, 4), generator=torch.Generator(device="cpu").manual_seed(1)).to(cuda_device)
    a1 = flush_pixels(fb0.clone(), *lanes, (float("inf"), 2.0, 1.0))
    a2 = flush_plain(fb0.clone(), *lanes, (float("inf"), 2.0, 1.0))
    torch.cuda.synchronize()
    assert torch.equal(a1[:, 3], a2[:, 3])
    torch.testing.assert_close(a1, a2, rtol=4e-6, atol=4e-6 * float(a2[:, 0:3].abs().max()))


@pytest.mark.parametrize("n", [0, 1, 27, 28, 31, 129])
@pytest.mark.parametrize("mode", ["drop", "clamp_edge", "tile"])
@pytest.mark.parametrize("name,r", [("Mitchell", 2), ("Blackman", 1)])
def test_accum_filtered_small_widths(cuda_device, n, mode, name, r):
    """A few lanes splatting into a 16x4 frame, several on one pixel and
    every footprint crossing the edge: taps dropped, clamped onto the edge,
    or dropped outside a dispatch of rows [16, 48) (tile)."""
    import chip_smoke
    from zyg_tpu_torch.ops.accum import flush_filtered, flush_filtered_plain

    pid, was_alive, alive, *planes = chip_smoke._flush_lanes(max(n, 1), 0.5, cuda_device)
    rows, base = (32, 16) if mode == "tile" else (64, 0)
    uv = torch.rand((max(n, 1), 2), generator=torch.Generator(device="cpu").manual_seed(2))
    args = [pid[:n] % rows, was_alive[:n], alive[:n], [p[:n] for p in planes],
            (float("inf"), 2.0, 1.0), uv[:n].to(cuda_device), 16, 4, name, r]
    if mode == "clamp_edge":
        args[1:5] = [None, None, args[3][:1], (float("inf"),)]
    fb0 = torch.rand((rows, 4), generator=torch.Generator(device="cpu").manual_seed(1)).to(cuda_device)
    kw = dict(clamp_edge=mode == "clamp_edge", base=base)
    a1 = flush_filtered(fb0.clone(), *args, **kw)
    a2 = flush_filtered_plain(fb0.clone(), *args, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(a1, a2, rtol=1e-5, atol=1e-5 * float(a2.abs().max()))


@pytest.mark.parametrize("mode", ["clamp_edge", "tile"])
@pytest.mark.parametrize("name,r", [("Mitchell", 2), ("Blackman", 1)])
@pytest.mark.parametrize("tap_major", [True, False])
def test_accum_filtered_one_pixel(cuda_device, mode, name, r, tap_major):
    """Every finishing lane of two warps on one pixel of a 16x4 frame (the
    tile: rows [16, 48) of it): each atomic instruction adds many taps to
    the same rows, under both of the kernel's mappings (taps shared by the
    warp's threads, or one thread a lane) and through the wrapper."""
    from zyg_tpu_torch.ops.accum import _launch_filtered, flush_filtered, flush_filtered_plain

    n = 64
    g = torch.Generator(device="cpu").manual_seed(3)
    rows, base = (32, 16) if mode == "tile" else (64, 0)
    pid = torch.full((n,), 21, dtype=torch.int64)
    fin = torch.rand(n, generator=g) < 0.6
    planes = [(torch.rand((n, 3), generator=g) * 4.0).to(cuda_device) for _ in range(3)]
    uv = torch.rand((n, 2), generator=g).to(cuda_device)
    args = [pid.to(cuda_device), fin.to(cuda_device), torch.zeros(n, dtype=torch.bool,
                                                                  device=cuda_device),
            planes, (float("inf"), 2.0, 1.0), uv, 16, 4, name, r]
    if mode == "clamp_edge":
        args[1:5] = [None, None, planes[:1], (float("inf"),)]
    fb0 = torch.rand((rows, 4), generator=g).to(cuda_device)
    edge = mode == "clamp_edge"
    want = flush_filtered_plain(fb0.clone(), *args, clamp_edge=edge, base=base)
    got = fb0.clone()
    _launch_filtered(got, *args, edge, base, tap_major=tap_major)
    wrapped = flush_filtered(fb0.clone(), *args, clamp_edge=edge, base=base)
    torch.cuda.synchronize()
    for a in (got, wrapped):
        torch.testing.assert_close(a, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("case", SHAPES + ["all dead"])
def test_shade_launch_shapes(cuda_device, case):
    import chip_smoke
    from zyg_tpu_torch.core.sobol import SobolSampler
    from zyg_tpu_torch.ops import shade

    n = 129 if case == "all dead" else _lanes(case, "zyg_shade_resident_lanes")
    tables = shade.pack_tables(chip_smoke._cornell(cuda_device))
    s = chip_smoke._shade_state(n, cuda_device)
    if case == "all dead":
        s.alive = torch.zeros_like(s.alive)
    smp = SobolSampler(s.sobol, dim=5)
    smp.sample_4d()
    ua = smp.arrays.buffer
    smp.sample_3d()
    ub = smp.arrays.buffer
    st = s.fields()
    r1 = shade.fused_bounce(tables, st, ua, ub, 16, False, False)
    r2 = shade.bounce_plain(tables, st, ua, ub, 16, False, False)
    torch.cuda.synchronize()
    chip_smoke.compare_bounce(r1, r2)
    if case == "all dead":
        # every lane writes its path state through and traces nothing
        assert int(r1["rays"]) == 0 and not bool(r1["alive"].any())
        for name in ("o", "d", "depth", "mis_o", "mis_n", "emission", "direct", "indirect"):
            assert torch.equal(r1[name], st[name]), name


@pytest.fixture(scope="module")
def rotated_pair(cuda_device):
    """chip_smoke.check_traverse's rotated, non-uniformly scaled pair of
    trefoil instances (the second visible to reflection rays only)."""
    import numpy as np
    from zyg_tpu_torch.scene import trimesh
    from zyg_tpu_torch.scene.loader import rotation_matrix_from_euler_degrees

    arena, host = trimesh.build_arena([trimesh.make_trefoil_mesh(48, 32)])
    itab = trimesh.build_instance_table(host, [
        dict(prop=1, mesh=0, rot=rotation_matrix_from_euler_degrees([30, -50, 70]),
             pos=np.array([0.3, -0.2, 0.5], np.float32), scale=np.array([0.35, 0.5, 0.3], np.float32)),
        dict(prop=2, mesh=0, rot=np.eye(3, dtype=np.float32), pos=np.array([-0.5, 0.4, 0.1], np.float32),
             scale=np.full(3, 0.3, np.float32), vis=(False, True, False)),
    ])
    return arena.to(cuda_device), itab.to(cuda_device)


@pytest.mark.parametrize("case", SHAPES + ["all dead", "all miss"])
def test_traverse_launch_shapes(cuda_device, rotated_pair, case):
    import chip_smoke
    from zyg_tpu_torch.ops import traverse
    from zyg_tpu_torch.scene.types import RAY_MAX_T

    arena, itab = rotated_pair
    n = 129 if case in ("all dead", "all miss") else _lanes(case, "zyg_traverse_resident_lanes")
    o, d, tgt = chip_smoke._mesh_rays(n, cuda_device, seed=13)
    if case == "all miss":
        # from a sphere of radius 6 straight outward: no instance box is ahead
        d = o / o.norm(dim=1, keepdim=True)
        o = 6.0 * d
    g = torch.Generator(device="cpu").manual_seed(5)
    alive = (torch.rand(n, generator=g) < 0.9).to(cuda_device) & (case != "all dead")
    prim = (torch.rand(n, generator=g) < 0.5).to(cuda_device)
    tmax = torch.where(alive, RAY_MAX_T, 0.0)
    smax = torch.where(alive, (tgt - o).norm(dim=1), 0.0)
    k = traverse.intersect_instances(arena, itab, o, d, 0.0, tmax, "reflection", prim)
    p = traverse.traverse_plain(arena, itab, o, d, 0.0, tmax, 1, prim, False)
    kb = traverse.intersect_instances(arena, itab, o, d, 0.0, smax, "shadow", any_hit=True)
    pb = traverse.traverse_plain(arena, itab, o, d, 0.0, smax, 2, None, True)
    torch.cuda.synchronize()
    traverse.check_errors(cuda_device)
    chip_smoke._compare_walks(k, p, f"traverse ({case})")
    assert torch.equal(kb, pb)
    if case in ("all dead", "all miss"):
        assert not bool((k[1] >= 0).any()) and not bool(kb.any())


@pytest.fixture(scope="module")
def moving_pair(cuda_device):
    """rotated_pair with its first instance moving over the shutter: a
    step, a turn and a change of scale (the kAnim variant's table)."""
    import numpy as np
    from zyg_tpu_torch.scene import trimesh
    from zyg_tpu_torch.scene.loader import rotation_matrix_from_euler_degrees as rot

    arena, host = trimesh.build_arena([trimesh.make_trefoil_mesh(48, 32)])
    itab = trimesh.build_instance_table(host, [
        dict(prop=1, mesh=0, rot=rot([30, -50, 70]), pos=np.float32([0.3, -0.2, 0.5]),
             scale=np.float32([0.35, 0.5, 0.3]), rot1=rot([10, 40, 75]),
             pos1=np.float32([0.9, 0.3, 0.2]), scale1=np.float32([0.45, 0.4, 0.3])),
        dict(prop=2, mesh=0, rot=np.eye(3, dtype=np.float32), pos=np.float32([-0.5, 0.4, 0.1]),
             scale=np.full(3, 0.3, np.float32), vis=(False, True, False)),
    ])
    assert itab.has_anim
    return arena.to(cuda_device), itab.to(cuda_device)


@pytest.mark.parametrize("case", SHAPES + ["all dead", "all miss"])
def test_traverse_anim_launch_shapes(cuda_device, moving_pair, case):
    """The kAnim variant at the persistent grid's launch shapes, with
    seeded shutter times: hit records against the plain walk (ids exact
    except at exact-t ties, t/u/v within rtol 2e-5), any-hit exact; a
    moving table without times raises before any launch."""
    import chip_smoke
    from zyg_tpu_torch import ops
    from zyg_tpu_torch.ops import traverse
    from zyg_tpu_torch.scene.types import RAY_MAX_T

    arena, itab = moving_pair
    n = 129 if case in ("all dead", "all miss") else _lanes(case, "zyg_traverse_anim_resident_lanes")
    o, d, tgt = chip_smoke._mesh_rays(n, cuda_device, seed=19)
    if case == "all miss":
        d = o / o.norm(dim=1, keepdim=True)
        o = 6.0 * d
    g = torch.Generator(device="cpu").manual_seed(7)
    alive = (torch.rand(n, generator=g) < 0.9).to(cuda_device) & (case != "all dead")
    prim = (torch.rand(n, generator=g) < 0.5).to(cuda_device)
    time = torch.rand(n, generator=g).to(cuda_device)
    tmax = torch.where(alive, RAY_MAX_T, 0.0)
    smax = torch.where(alive, (tgt - o).norm(dim=1), 0.0)
    with pytest.raises(ValueError, match="shutter times"):
        traverse.intersect_instances(arena, itab, o, d, 0.0, tmax, "reflection", prim)
    before = ops.launch_counts()["traverse_anim"]
    k = traverse.intersect_instances(arena, itab, o, d, 0.0, tmax, "reflection", prim, time=time)
    p = traverse.traverse_plain(arena, itab, o, d, 0.0, tmax, 1, prim, False, time=time)
    kb = traverse.intersect_instances(arena, itab, o, d, 0.0, smax, "shadow", any_hit=True,
                                      time=time)
    pb = traverse.traverse_plain(arena, itab, o, d, 0.0, smax, 2, None, True, time=time)
    torch.cuda.synchronize()
    traverse.check_errors(cuda_device)
    assert ops.launch_counts()["traverse_anim"] == before + (2 if n > 0 else 0)
    chip_smoke._compare_walks(k, p, f"traverse_anim ({case})")
    assert torch.equal(kb, pb)
    if case in ("all dead", "all miss"):
        assert not bool((k[1] >= 0).any()) and not bool(kb.any())


@pytest.fixture(scope="module")
def deforming_tables(cuda_device):
    """A trefoil whose second position frame is displaced (a deforming
    arena) beside a static sphere, under rotated_pair's two instances, and
    the same with the first instance moving."""
    import numpy as np
    import chip_smoke
    from zyg_tpu_torch.scene import trimesh
    from zyg_tpu_torch.scene.loader import rotation_matrix_from_euler_degrees as rot

    m = trimesh.make_trefoil_mesh(48, 32)
    m = m._replace(positions_end=chip_smoke._displaced(m))
    arena, host = trimesh.build_arena([m, trimesh.make_sphere_mesh(8, 12)])
    first = dict(prop=1, mesh=0, rot=rot([30, -50, 70]), pos=np.float32([0.3, -0.2, 0.5]),
                 scale=np.float32([0.35, 0.5, 0.3]))
    second = dict(prop=2, mesh=1, rot=np.eye(3, dtype=np.float32),
                  pos=np.float32([-0.5, 0.4, 0.1]), scale=np.full(3, 0.6, np.float32),
                  vis=(False, True, False))
    still = trimesh.build_instance_table(host, [first, second])
    moving = trimesh.build_instance_table(host, [
        dict(first, rot1=rot([10, 40, 75]), pos1=np.float32([0.9, 0.3, 0.2]),
             scale1=np.float32([0.45, 0.4, 0.3])), second])
    assert arena.tri_rows_d is not None and moving.has_anim and not still.has_anim
    return arena.to(cuda_device), {"still": still.to(cuda_device),
                                   "moving": moving.to(cuda_device)}


@pytest.mark.parametrize("table", ["still", "moving"])
@pytest.mark.parametrize("case", SHAPES + ["all dead", "all miss"])
def test_traverse_deform_launch_shapes(cuda_device, deforming_tables, table, case):
    """The deforming forms (traverse_deform over a static table,
    traverse_anim_deform over a moving one) at the persistent grid's
    launch shapes, at seeded shutter times with 0 and 1 on some lanes and
    a NaN ray: every hit record and any-hit flag equal to the plain
    walk's; without times the walk is the walk at time 0."""
    import chip_smoke
    from zyg_tpu_torch import ops
    from zyg_tpu_torch.ops import traverse
    from zyg_tpu_torch.scene.types import RAY_MAX_T

    arena, tables = deforming_tables
    itab = tables[table]
    name = "traverse_anim_deform" if table == "moving" else "traverse_deform"
    n = 129 if case in ("all dead", "all miss") else _lanes(case, f"zyg_{name}_resident_lanes")
    o, d, tgt = chip_smoke._mesh_rays(n, cuda_device, seed=23)
    if case == "all miss":
        d = o / o.norm(dim=1, keepdim=True)
        o = 6.0 * d
    g = torch.Generator(device="cpu").manual_seed(11)
    alive = (torch.rand(n, generator=g) < 0.9).to(cuda_device) & (case != "all dead")
    prim = (torch.rand(n, generator=g) < 0.5).to(cuda_device)
    time = torch.rand(n, generator=g).to(cuda_device)
    if n > 40:
        time[:16], time[16:32] = 0.0, 1.0
        d[33] = float("nan")
    tmax = torch.where(alive, RAY_MAX_T, 0.0)
    smax = torch.where(alive, (tgt - o).norm(dim=1), 0.0)
    before = ops.launch_counts()[name]
    k = traverse.intersect_instances(arena, itab, o, d, 0.0, tmax, "reflection", prim, time=time)
    p = traverse.traverse_plain(arena, itab, o, d, 0.0, tmax, 1, prim, False, time=time)
    kb = traverse.intersect_instances(arena, itab, o, d, 0.0, smax, "shadow", any_hit=True,
                                      time=time)
    pb = traverse.traverse_plain(arena, itab, o, d, 0.0, smax, 2, None, True, time=time)
    torch.cuda.synchronize()
    traverse.check_errors(cuda_device)
    assert ops.launch_counts()[name] == before + (2 if n > 0 else 0)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert torch.equal(kb, pb)
    if case in ("all dead", "all miss"):
        assert not bool((k[1] >= 0).any()) and not bool(kb.any())
    if table == "still" and n > 0:
        k0 = traverse.intersect_instances(arena, itab, o, d, 0.0, tmax, "reflection", prim)
        kz = traverse.intersect_instances(arena, itab, o, d, 0.0, tmax, "reflection", prim,
                                          time=torch.zeros_like(time))
        assert all(torch.equal(a, b) for a, b in zip(k0, kz))


def test_traverse_deform_rejects_misaligned_deltas(cuda_device, deforming_tables):
    """The leaf deltas are read as 16-byte loads too: a misaligned
    tri_rows_d is refused, never walked."""
    import dataclasses

    import chip_smoke
    from zyg_tpu_torch.ops import traverse

    arena, tables = deforming_tables
    rows = arena.tri_rows_d
    shifted = torch.empty(rows.numel() + 1, dtype=rows.dtype, device=cuda_device)[1:].view(rows.shape)
    shifted.copy_(rows)
    bad = dataclasses.replace(arena, tri_rows_d=shifted)
    o, d, _ = chip_smoke._mesh_rays(64, cuda_device, seed=13)
    with pytest.raises(ValueError, match="16-byte aligned"):
        traverse.intersect_instances(bad, tables["still"], o, d, 0.0, 1e30, "reflection",
                                     time=torch.zeros(64, device=cuda_device))


def _pick_case(dev, ninst: int, moving: bool, n: int = 4096, seed: int = 41):
    """An instance table of ninst rows where the pick is delicate: up to 8
    clusters (one from 5 rows on, one each 10 rows from 20) of 5 identical
    sphere instances (one box each cluster, props 10c + m + 1; member
    m < 3 hidden from ray class m), the rest scattered
    spheres and cubes (props 1000 + k) in a cube whose volume grows with
    ninst; moving: cluster 0 turns from 170 to 190 degrees about y (the
    quaternions' dot product is negative), cluster 1 repeats its start row
    as its end row (slerp's close branch), every third scattered row
    moves. A third of the rays start inside a cluster (entry t 0 in all of
    its boxes; inside the one sphere when ninst is 1). Returns (arena,
    itab, o, d, tmax, smax, time or None, primary)."""
    import numpy as np
    from zyg_tpu_torch.scene import trimesh
    from zyg_tpu_torch.scene.loader import rotation_matrix_from_euler_degrees as rot

    rng = np.random.default_rng(seed + ninst)
    reach = 2.5 * max(ninst / 36.0, 1.0) ** (1.0 / 3.0)
    nclus = min(max(ninst // 10, int(ninst >= 5)), 8)
    centres = rng.uniform(-reach / 2, reach / 2, (max(nclus, 1), 3)).astype(np.float32)
    inst = []
    for c in range(nclus):
        base = dict(mesh=0, rot=rot([20.0 * c, 170.0 if c == 0 else 35.0 * c, 0.0]),
                    pos=centres[c], scale=np.full(3, 0.6, np.float32))
        if moving and c == 0:
            base.update(rot1=rot([0.0, 190.0, 0.0]), pos1=centres[c] + np.float32([0.1, 0, 0]),
                        scale1=np.full(3, 0.55, np.float32))
        if moving and c == 1:
            base.update(rot1=base["rot"], pos1=base["pos"], scale1=base["scale"])
        inst += [dict(base, prop=10 * c + m + 1, vis=tuple(k != m for k in range(3)))
                 for m in range(5)]
    for k in range(ninst - len(inst)):
        angles = rng.uniform(-180.0, 180.0, 3)
        pos = rng.uniform(-reach, reach, 3).astype(np.float32)
        scale = rng.uniform(0.2, 0.5, 3).astype(np.float32)
        ins = dict(prop=1000 + k, mesh=k % 2, rot=rot(angles), pos=pos, scale=scale,
                   vis=tuple(bool(v) for v in rng.random(3) > 0.15))
        if ninst == 1:
            ins.update(mesh=0, rot=rot([0.0, 170.0, 0.0]), pos=np.zeros(3, np.float32),
                       scale=np.full(3, 0.8, np.float32), vis=(True, True, True))
        if moving and (k % 3 == 0 or ninst == 1):
            ins.update(rot1=rot([0.0, 190.0, 0.0]) if ninst == 1 else
                       rot(angles + rng.uniform(-60.0, 60.0, 3)),
                       pos1=(ins["pos"] + rng.uniform(-0.3, 0.3, 3)).astype(np.float32),
                       scale1=(ins["scale"] * rng.uniform(0.8, 1.2, 3)).astype(np.float32))
        inst.append(ins)
    arena, host = trimesh.build_arena([trimesh.make_sphere_mesh(8, 12), trimesh.make_cube_mesh()])
    itab = trimesh.build_instance_table(host, inst)
    assert itab.trafo.shape[0] == ninst and itab.has_anim == moving
    if moving:
        tf = itab.trafo
        assert bool(((tf[:, 0:4] * tf[:, 10:14]).sum(1) < 0).any())  # the flip
        assert bool((tf[:, 0:10] != tf[:, 10:20]).any(1).any())
        if ninst > 1:
            assert bool((tf[:, 0:10] == tf[:, 10:20]).all(1).any())  # close rows
    k = n // 3
    o = rng.uniform(-reach - 0.5, reach + 0.5, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-reach / 2, reach / 2, (n, 3)).astype(np.float32)
    o[:k] = (centres[rng.integers(0, max(nclus, 1), k)] if nclus else 0.0) \
        + rng.uniform(-0.08, 0.08, (k, 3)).astype(np.float32)
    tgt[:k] = o[:k] + rng.normal(size=(k, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    time = rng.random(n).astype(np.float32)
    time[:64], time[64:128] = 0.0, 1.0
    tmax = np.full(n, 2.14748313e9, np.float32)
    tmax[::11] = 0.0
    smax = np.linalg.norm(tgt - o, axis=1).astype(np.float32)
    smax[::7] = 0.0
    primary = rng.random(n) < 0.5

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return (arena.to(dev), itab.to(dev), t(o), t(d.astype(np.float32)), t(tmax), t(smax),
            t(time) if moving else None, t(primary))


def _check_pick(dev, ninst: int, moving: bool, n: int = 4096) -> None:
    """_pick_case's table and rays through the kernel and the plain walk:
    hit ids exact on every lane, the records bit-exact (static) or t/u/v
    within rtol 2e-5 (moving), any-hit exact; a cluster hit carries the
    cluster's first member visible to the ray's class."""
    import chip_smoke
    from zyg_tpu_torch import ops
    from zyg_tpu_torch.ops import traverse

    arena, itab, o, d, tmax, smax, time, prim = _pick_case(dev, ninst, moving, n)
    name = "traverse_anim" if moving else "traverse"
    before = ops.launch_counts()[name]
    k = traverse.intersect_instances(arena, itab, o, d, 0.0, tmax, "reflection", prim, time=time)
    p = traverse.traverse_plain(arena, itab, o, d, 0.0, tmax, 1, prim, False, time=time)
    kb = traverse.intersect_instances(arena, itab, o, d, 0.0, smax, "shadow", any_hit=True,
                                      time=time)
    pb = traverse.traverse_plain(arena, itab, o, d, 0.0, smax, 2, None, True, time=time)
    torch.cuda.synchronize()
    traverse.check_errors(dev)
    assert ops.launch_counts()[name] == before + 2
    assert torch.equal(kb, pb) and 0 < int(pb.sum()) < o.shape[0]
    assert torch.equal(k[1], p[1]) and torch.equal(k[4], p[4])
    if moving:
        chip_smoke._compare_walks(k, p, f"{name} ({ninst} instances)")
    else:
        assert all(torch.equal(a, b) for a, b in zip(k, p))
    prop = k[4].cpu()
    cluster = (prop >= 1) & (prop <= 80)
    first = torch.where(prim.cpu(), 1, 0)  # member 0 is hidden from the camera column
    assert torch.equal(prop[cluster], ((prop - 1) // 10 * 10 + first + 1)[cluster])
    if ninst >= 5:
        assert int(cluster.sum()) >= o.shape[0] // 10


@pytest.mark.parametrize("moving", [False, True], ids=["static", "moving"])
@pytest.mark.parametrize("ninst", [1, 7, 8, 31, 32, 33, 144, 1000])
def test_traverse_pick_on_tied_tables(cuda_device, ninst, moving):
    """The instance pick in both of the kernel's forms: the lane pick
    below the warp pick's 8 rows (1 and 7 rows), the warp pick from 8
    rows on (8 rows: its threshold; 31-33 rows: one or two box rounds a
    thread; 144 and 1,000 rows), with ties at entry t 0 in clusters of
    identical boxes, rows hidden from a ray class, any-hit rays that stop
    at their first hit, and moving rows with times 0 and 1, equal start
    and end rows and a negative quaternion dot product (_check_pick)."""
    _check_pick(cuda_device, ninst, moving)


@pytest.mark.parametrize("moving", [False, True], ids=["static", "moving"])
def test_traverse_warp_pick_launch_shapes(cuda_device, moving):
    """The warp pick's form (144 rows) over one lane more than a pass of
    the resident grid covers, so that warps take rays from the counter
    more than once (_check_pick)."""
    symbol = "zyg_traverse_anim_resident_lanes" if moving else "zyg_traverse_resident_lanes"
    _check_pick(cuda_device, 144, moving, _lanes("resident+1", symbol))


@pytest.mark.parametrize("field", ["node_rows", "tri_rows"])
def test_traverse_rejects_misaligned_arena(cuda_device, rotated_pair, field):
    """The kernel reads arena rows as 16-byte loads: a row tensor that
    starts off a 16-byte boundary is refused, never walked."""
    import dataclasses

    import chip_smoke
    from zyg_tpu_torch.ops import traverse

    arena, itab = rotated_pair
    rows = getattr(arena, field)
    shifted = torch.empty(rows.numel() + 1, dtype=rows.dtype, device=cuda_device)[1:].view(rows.shape)
    shifted.copy_(rows)
    bad = dataclasses.replace(arena, **{field: shifted})
    o, d, _ = chip_smoke._mesh_rays(64, cuda_device, seed=13)
    with pytest.raises(ValueError, match="16-byte aligned"):
        traverse.intersect_instances(bad, itab, o, d, 0.0, 1e30, "reflection")


@pytest.mark.parametrize("case", SHAPES + ["all dead", "all miss"])
def test_surface_launch_shapes(cuda_device, case):
    """Kernel 5 on the bench trefoil at its resident grid's launch shapes,
    all lanes dead, and all rays missing (fired outward from a sphere of
    radius 12, beyond every prop: every lane ends before NEE), under
    compare_surface's rules."""
    import chip_smoke
    from zyg_tpu_torch.ops import surface

    n = 129 if case in ("all dead", "all miss") else _lanes(case, "zyg_surface_resident_lanes")
    scene = chip_smoke._trefoil(cuda_device)
    tables = surface.pack_mesh_tables(scene)
    s = chip_smoke._surface_lanes(n, cuda_device)
    if case == "all dead":
        s.alive = torch.zeros_like(s.alive)
    if case == "all miss":
        s.d = s.o / s.o.norm(dim=1, keepdim=True)
        s.o = 12.0 * s.d
    st, ua, ub = chip_smoke.surface_inputs(scene, tables, s)
    r1 = surface.surface(tables, st, ua, ub, 4, True, False)
    r2 = surface.surface_plain(tables, st, ua, ub, 4, True, False)
    torch.cuda.synchronize()
    chip_smoke.compare_surface(r1, r2)
    if case in ("all dead", "all miss"):
        assert not bool(r1["alive"].any()) and not bool(r1["nee_active"].any())
        for name in ("o", "d", "depth", "mis_o", "mis_n"):
            assert torch.equal(r1[name], st[name]), name
    if case == "all dead":
        assert int(r1["rays"]) == 0
        for name in ("emission", "direct", "indirect"):
            assert torch.equal(r1[name], st[name]), name


@pytest.mark.parametrize("case", SHAPES + ["all dead", "all miss"])
def test_surface_v2_launch_shapes(cuda_device, case):
    """Kernel 6 on the CI textured trefoil's glue output at its resident
    grid's launch shapes, all lanes dead, and all rays missing the finite
    surfaces (fired outward from a sphere of radius 12, beyond the ground:
    they reach only the sky dome), under compare_surface_v2's rules."""
    import chip_smoke
    from zyg_tpu_torch.ops import surface_v2
    from zyg_tpu_torch.render.integrator.ptmis import PtmisSettings

    n = 129 if case in ("all dead", "all miss") else _lanes(case, "zyg_surface_v2_resident_lanes")
    _, scene = chip_smoke._textured(cuda_device, ci=True)
    body = surface_v2.make_mesh_fused_body_v2(scene, PtmisSettings(max_depth=4))
    s = chip_smoke._surface_lanes(n, cuda_device)
    if case == "all dead":
        s.alive = torch.zeros_like(s.alive)
    if case == "all miss":
        s.d = s.o / s.o.norm(dim=1, keepdim=True)
        s.o = 12.0 * s.d
    st, ua, ub, *_ = body.inputs(s)
    r1 = surface_v2.surface_v2(body.fit, st, ua, ub, 4, True, False)
    r2 = surface_v2.surface_v2_plain(st, ua, ub, 4, True, False)
    torch.cuda.synchronize()
    chip_smoke.compare_surface_v2(r1, r2)
    if case in ("all dead", "all miss"):
        assert not bool(r1["alive"].any()) and not bool(r1["nee_active"].any())
        for name in ("o", "d", "depth", "mis_o", "mis_n"):
            assert torch.equal(r1[name], st[name]), name
    if case == "all dead":
        assert int(r1["rays"]) == 0
        for name in ("emission", "direct", "indirect"):
            assert torch.equal(r1[name], st[name]), name


def test_isect_on_material_tables(cuda_device):
    """isect over material_test's own prop tables (spheres, a rectangle
    floor and lamp, a dome) at the material path's 786,432 lanes against
    its plain version: prop ids and any-hit exact."""
    import chip_smoke

    chip_smoke.check_isect_material(cuda_device)


@pytest.fixture(scope="module")
def material_lanes():
    """129 general-body lanes after four plain bounces (on the CPU)."""
    import chip_smoke

    return chip_smoke.material_state(129)


@pytest.mark.parametrize("case", [0, 1, 31, 129, "all dead"])
def test_general_body_launch_shapes(cuda_device, material_lanes, case):
    """The general body (torch around isect and sobol_block) on the card
    against the same body on the CPU at 0, 1, 31 and 129 lanes and with
    every lane dead: shapes right, lifecycles exact (compare_general), and
    dead lanes keep their path and stack."""
    import dataclasses

    import chip_smoke
    from zyg_tpu_torch.render.integrator import ptmis

    s = material_lanes
    n = 129 if case == "all dead" else case
    s = s.index(torch.arange(n))
    if case == "all dead":
        s = dataclasses.replace(s, alive=torch.zeros_like(s.alive),
                                split={**s.split, "pending": torch.zeros_like(s.alive)})
    settings = ptmis.PtmisSettings(max_depth=chip_smoke.MATERIAL_DEPTH, bsdf_split=True)
    cpu_body = ptmis._make_body(chip_smoke._material("cpu"), settings)
    card_body = ptmis._make_body(chip_smoke._material(cuda_device), settings)
    sc = chip_smoke.to_device(s, cuda_device)
    r1 = card_body(ptmis.resume_split(sc))
    r2 = cpu_body(ptmis.resume_split(s))
    torch.cuda.synchronize()
    assert r1.o.shape == (n, 3) and r1.medium.shape == (n, 4) and r1.split["o"].shape == (n, 3)
    chip_smoke.compare_general(r1, r2)
    dead = ~sc.alive & ~sc.split["pending"]
    for name in ("o", "d", "depth", "medium", "mis_o", "mis_n"):
        assert torch.equal(getattr(r1, name)[dead], getattr(sc, name)[dead]), name
    if case == "all dead":
        assert int(r1.rays) == 0 and not bool(r1.alive.any())


def test_track_matches_plain_on_card(cuda_device):
    """Both tracking walks on the smoke path's own glue inputs at its
    518,400 lanes (chip_smoke.check_track): decisions exact, t/w/trv/tau
    within rtol 1e-5."""
    import chip_smoke

    result = chip_smoke.check_track(cuda_device)  # raises on any disagreement
    assert set(result) == {"track_interaction", "track_transmittance"}
    assert all(r["ms"] > 0.0 for r in result.values())


@pytest.fixture(scope="module")
def walk_inputs(cuda_device):
    import chip_smoke

    return chip_smoke._smoke_walk_inputs(cuda_device)


def _walk_case(args, lanes_at: int, n: int, case):
    """args with their lane tensors cut to n lanes; "all done": no lane
    walks; "nan": lane 5's direction is NaN."""
    lanes = dict(args[lanes_at])
    cut = {k: v[:n].clone() for k, v in lanes.items()}
    if case == "all done":
        if "grid" in cut:
            cut["grid"].fill_(-1)
        else:
            cut["inside"].fill_(False)
    if case == "nan":
        for k in ("d", "ld", "inv"):
            cut[k][5] = float("nan")
        if "grid" in cut:  # a walking lane, in the medium's prop
            cut["grid"][5] = int(lanes["grid"].max())
            cut["mp"][5] = int(lanes["mp"].max())
        else:
            cut["inside"][5] = True
    out = list(args)
    out[lanes_at] = cut
    if lanes_at == 2:  # the interaction's per-lane coefficients
        out[3] = {k: v[:n].contiguous() for k, v in args[3].items()}
    return tuple(out)


@pytest.mark.parametrize("walk", ["interaction", "transmittance"])
@pytest.mark.parametrize("case", [0, 1, 31, 129, 4096, "all done", "nan"])
def test_track_launch_shapes(cuda_device, walk_inputs, walk, case):
    """Each walk against its plain version at 0, 1, 31, 129 and 4,096
    lanes, and at 129 lanes with no lane walking; and a lane whose
    direction is NaN, which never leaves its segment and must stop at the
    step cap (16,384 steps) with the plain version's outputs (the plain
    walk of that one lane runs on the CPU: 16,384 steps of small launches
    on the card take minutes)."""
    from zyg_tpu_torch.ops import track

    ia, ta = walk_inputs
    if walk == "interaction":
        args, at = ia, 2
        kfn, pfn = track.track_interaction, track.track_interaction_plain
    else:
        args, at = ta, 5
        kfn, pfn = track.track_transmittance, track.track_transmittance_plain
    n = 129 if case in ("all done", "nan") else case
    args = _walk_case(args, at, n, case)
    plain_args = args
    if case == "nan":  # the NaN lane alone
        args = list(args)
        args[at] = {k: v[5:6].contiguous() for k, v in args[at].items()}
        if at == 2:
            args[3] = {k: v[5:6].contiguous() for k, v in args[3].items()}
        args = tuple(args)
        plain_args = tuple(_to_cpu(x) for x in args)
    k = kfn(*args)
    stats = {}
    p = pfn(*plain_args, stats=stats)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        b = b.to(a.device)
        assert a.shape == b.shape
        if a.dtype == torch.bool:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7, equal_nan=True)
    if case == "all done":
        assert stats.get("steps", 0) == 0
        assert torch.equal(k[0], torch.zeros_like(k[0]) if walk == "interaction"
                           else torch.ones_like(k[0]))
    if case == "nan":
        assert stats["iterations"] == track.MAX_STEPS


def _to_cpu(x):
    """A walk argument (tensor, dict of tensors, arena, tuple) on the CPU."""
    from zyg_tpu_torch.scene.grids import GridArena

    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: v.cpu() for k, v in x.items()}
    if isinstance(x, GridArena):
        return x.to("cpu")
    if isinstance(x, tuple):
        return tuple(_to_cpu(v) for v in x)
    return x


@pytest.fixture(scope="module")
def fire_walk_inputs(cuda_device):
    """The emissive walk's glue inputs at the fire path's 518,400 lanes,
    grey (fire.scene) and spectral (its non-grey copy)."""
    import chip_smoke

    return {v: chip_smoke._fire_walk_inputs(cuda_device, v) for v in ("fire", "spectral")}


def _emissive_case(inputs, case):
    """(kernel args, plain args) of the emissive walk cut to a case: n
    lanes from the image's middle row on; "all absorbed": 4,096 lanes that
    the plain walk absorbs;
    "nan": one walking lane whose direction is NaN (its plain walk on the
    CPU)."""
    arena, props, lanes, coef, grey, e_med = inputs
    n = lanes["grid"].shape[0]
    if case == "all absorbed":
        from zyg_tpu_torch.ops import track

        absorbed = track.track_interaction_plain(arena, props, lanes, coef, grey, e_med=e_med)[3]
        idx = torch.nonzero(absorbed).squeeze(1)[:4096]
    elif case == "nan":
        idx = torch.nonzero(lanes["grid"] >= 0).squeeze(1)[:1]
    else:  # from the middle row of the image down, through the fire
        start = n // 2
        idx = torch.arange(start, start + min(case, n - start), device=e_med.device)
    cut = {k: v[idx].contiguous() for k, v in lanes.items()}
    if case == "nan":
        for k in ("d", "ld", "inv"):
            cut[k][0] = float("nan")
    args = (arena, props, cut, {k: v[idx].contiguous() for k, v in coef.items()}, grey,
            e_med[idx].contiguous())
    if case != "nan":
        return args, args
    return args, tuple(_to_cpu(x) for x in args)


@pytest.mark.parametrize("variant", ["fire", "spectral"])
@pytest.mark.parametrize("case", [0, 1, 4096, "all absorbed", "nan"])
def test_emissive_track_launch_shapes(cuda_device, fire_walk_inputs, variant, case):
    """track_interaction's emissive variant against its plain version at
    0, 1 and 4,096 of the fire path's lanes, on 4,096 lanes that all end
    in an absorption (each collects emission), and on a lane whose
    direction is NaN, which must stop at the step cap with no emission:
    t, w, decisions and emission bit-exact."""
    from zyg_tpu_torch.ops import track

    args, plain_args = _emissive_case(fire_walk_inputs[variant], case)
    k = track.track_interaction(*args[:5], e_med=args[5])
    stats = {}
    p = track.track_interaction_plain(*plain_args[:5], stats=stats, e_med=plain_args[5])
    torch.cuda.synchronize()
    assert len(k) == len(p) == 5
    for a, b in zip(k, p):
        b = b.to(a.device)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a, b) or (a.dtype != torch.bool
                                     and torch.equal(a.isnan(), b.isnan())
                                     and torch.equal(a[~a.isnan()], b[~b.isnan()]))
    if case == 4096:
        assert int((args[2]["grid"] >= 0).sum()) > 1000 and bool(k[2].any())
    if case == "all absorbed":
        assert bool(k[3].all()) and bool((k[4].amax(-1) > 0).all())
    if case == "nan":
        assert stats["iterations"] == track.MAX_STEPS and not bool(k[4].any())


def _doubled_with_nan(args, at: int, j: int):
    """args with each lane tensor twice over (lanes n..2n-1 repeat 0..n-1,
    keys included), lane j's direction NaN and j walking."""
    lanes = {k: torch.cat([v, v]) for k, v in args[at].items()}
    for k in ("d", "ld", "inv"):
        lanes[k][j] = float("nan")
    out = list(args)
    out[at] = lanes
    if at == 2:
        out[3] = {k: torch.cat([v, v]) for k, v in args[3].items()}
    return tuple(out)


@pytest.mark.parametrize("walk", ["interaction", "transmittance"])
def test_track_more_lanes_than_a_wave(cuda_device, walk_inputs, walk):
    """Each walk on smoke's 518,400 lanes twice over (1,036,800 lanes, many
    passes of the resident grid's threads), with a NaN lane among the
    walking lanes of the first half: every other lane equals the plain
    walk on the card (decisions exact, floats within rtol 1e-5), the
    second half equals the first, and the NaN lane stops at the step cap
    with its plain walk's outputs (run on the CPU, as the "nan" case
    does)."""
    from zyg_tpu_torch.ops import track

    ia, ta = walk_inputs
    if walk == "interaction":
        args, at, flag = ia, 2, "grid"
        kfn, pfn = track.track_interaction, track.track_interaction_plain
    else:
        args, at, flag = ta, 5, "inside"
        kfn, pfn = track.track_transmittance, track.track_transmittance_plain
    n = args[at][flag].shape[0]
    walking = args[at][flag] >= 0 if flag == "grid" else args[at][flag]
    j = int(torch.nonzero(walking)[1000])
    doubled = _doubled_with_nan(args, at, j)
    k = kfn(*doubled)
    # the plain walk on the card with lane j not walking, then lane j alone on the CPU
    rest = list(doubled)
    rest[at] = dict(doubled[at])
    rest[at][flag] = doubled[at][flag].clone()
    rest[at][flag][j] = -1 if flag == "grid" else False
    p = pfn(*rest)
    one = list(doubled)
    one[at] = {key: v[j:j + 1].cpu() for key, v in doubled[at].items()}
    if at == 2:
        one[3] = {key: v[j:j + 1].cpu() for key, v in doubled[3].items()}
    one = [_to_cpu(x) for x in one]
    stats = {}
    p_nan = pfn(*one, stats=stats)
    torch.cuda.synchronize()
    assert stats["iterations"] == track.MAX_STEPS
    others = torch.ones(2 * n, dtype=torch.bool, device=cuda_device)
    others[j] = False
    for a, b, c in zip(k, p, p_nan):
        assert a.shape[0] == 2 * n
        if a.dtype == torch.bool:
            assert torch.equal(a[others], b[others])
            assert torch.equal(a[j:j + 1].cpu(), c)
        else:
            torch.testing.assert_close(a[others], b[others], rtol=1e-5, atol=1e-7)
            torch.testing.assert_close(a[j:j + 1].cpu(), c, rtol=1e-5, atol=1e-7, equal_nan=True)
        half = torch.arange(n, device=cuda_device) != j
        assert torch.equal(a[:n][half], a[n:][half])


@pytest.mark.parametrize("walk", ["interaction", "transmittance"])
def test_track_repeated_launches_agree(cuda_device, walk_inputs, walk):
    """Two launches in a row on the same inputs give equal outputs, two
    launches counted: the lane counter starts from zero at each launch."""
    from zyg_tpu_torch import ops
    from zyg_tpu_torch.ops import track

    ia, ta = walk_inputs
    kfn = track.track_interaction if walk == "interaction" else track.track_transmittance
    args = ia if walk == "interaction" else ta
    before = ops.launch_counts()[f"track_{walk}"]
    first = kfn(*args)
    second = kfn(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()[f"track_{walk}"] == before + 2
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _arena_case(dev, case):
    """A grid arena whose rows the kernels read from global memory ("dense
    multi": three 64^3 fbm grids, 1,536 rows; "sparse multi": three mostly
    empty 64^3 grids, page-table addressing) or stage on chip ("sparse
    one": one such grid, 512 rows)."""
    import numpy as np
    from zyg_tpu_torch.scene.grids import build_grid_arena, make_fbm_grid

    if case == "dense multi":
        grids = [make_fbm_grid(64, seed=s) for s in (1, 2, 3)]
    else:
        grids = []
        for s in range(1 if case == "sparse one" else 3):
            blob = np.zeros((64, 64, 64), np.float32)
            blob[5 + s:20, 10:30 + s, 30:50] = np.random.default_rng(s).random(
                (15 - s, 20 + s, 20)) * 2.0
            grids.append(blob)
    return build_grid_arena(grids).to(dev)


@pytest.mark.parametrize("walk", ["interaction", "transmittance"])
@pytest.mark.parametrize("case", ["dense multi", "sparse multi", "sparse one"])
def test_track_row_forms(cuda_device, walk_inputs, walk, case):
    """Both row forms of each walk against the plain version on the card,
    on smoke's lanes over other arenas: rows read from global memory
    (more than ROWS_ON_CHIP rows) and staged on chip (a sparse arena's
    pages too). The interaction lanes spread over the arena's grids, the
    transmittance walk takes the last grid. Decisions exact, floats within
    rtol 1e-5."""
    from zyg_tpu_torch.ops import track

    arena = _arena_case(cuda_device, case)
    g = arena.dims.shape[0]
    assert track.rows_on_chip(arena) == (case == "sparse one")
    assert arena.sparse == (case != "dense multi")
    ia, ta = walk_inputs
    if walk == "interaction":
        lanes = dict(ia[2])
        grid = lanes["grid"]
        lanes["grid"] = torch.where(grid >= 0, torch.arange(grid.shape[0], device=cuda_device) % g,
                                    -1).to(torch.int32)
        args = (arena, ia[1], lanes) + ia[3:]
        kfn, pfn = track.track_interaction, track.track_interaction_plain
    else:
        args = (arena, ta[1], ta[2], g - 1) + ta[4:]
        kfn, pfn = track.track_transmittance, track.track_transmittance_plain
    k = kfn(*args)
    stats = {}
    p = pfn(*args, stats=stats)
    torch.cuda.synchronize()
    assert stats["collisions"] > 1000
    for a, b in zip(k, p):
        if a.dtype == torch.bool:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_track_refuses_misaligned_rows_and_strided_lanes(cuda_device, walk_inputs):
    """Supergrid rows off a 16-byte boundary (read as float4, and staged
    on chip) and a lane input that is not contiguous are refused by name,
    before any launch."""
    import dataclasses

    from zyg_tpu_torch import ops
    from zyg_tpu_torch.ops import track

    ia, ta = walk_inputs
    arena = ia[0]
    buf = torch.empty(arena.sdata.numel() + 1, device=cuda_device)
    shifted = buf[1:].view_as(arena.sdata)
    shifted.copy_(arena.sdata)
    bad = dataclasses.replace(arena, sdata=shifted)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        track.track_interaction(bad, *ia[1:])
    with pytest.raises(ValueError, match="16-byte aligned"):
        track.track_transmittance(bad, *ta[1:])
    lanes = dict(ta[5])
    lanes["lo"] = lanes["lo"].t().contiguous().t()
    with pytest.raises(ValueError, match="track_transmittance.lo: expected a contiguous tensor"):
        track.track_transmittance(*ta[:5], lanes, ta[6])
    assert ops.launch_counts() == before


def test_fire_body_on_card_matches_cpu(cuda_device):
    """The general body over fire.scene (the emissive walk, volume lights in
    NEE, the xi3 draw) on the card against the CPU on 1,024 lanes after
    two bounces: lifecycles exact, floats within compare_general's
    tolerances, the emitted and indirect radiance within 1e-3 and the
    direct within 1e-2 (relative, |a - b| / (|b| + 1e-3): NEE through the
    fire multiplies a shadow walk's ratio estimate, which moves where the
    card's and the CPU's log round apart; the CPU test's tolerance)."""
    import chip_smoke
    from zyg_tpu_torch.render.integrator import ptmis

    s = chip_smoke.fire_state(1024, 2, seed=15)
    settings = ptmis.PtmisSettings(max_depth=chip_smoke.FIRE_DEPTH,
                                   max_depth_volume=chip_smoke.SMOKE_DEPTH_VOLUME)
    r1 = ptmis._make_body(chip_smoke._fire(cuda_device), settings)(
        chip_smoke.to_device(s, cuda_device))
    r2 = ptmis._make_body(chip_smoke._fire("cpu"), settings)(s)
    torch.cuda.synchronize()
    chip_smoke.compare_general(r1, r2)
    for c, tol in (("emission", 1e-3), ("indirect", 1e-3), ("direct", 1e-2)):
        a, b = getattr(r1.result, c).cpu().double(), getattr(r2.result, c).double()
        assert float(((a - b).abs() / (b.abs() + 1e-3)).max()) < tol, c
    assert float(r2.result.direct.sum()) > 0.0


def test_photon_gather_matches_plain_on_card(cuda_device):
    """The photon gather on caustics_photons.take's first-bounce lanes at
    480x270 over its 200,000-path map baked on the card, and on a dense
    map whose buckets exceed the 64-photon cap, at caps 64 and 4 (each
    lane within 2e-3 of its largest channel plus 1e-6 of the batch's
    largest value: shade_core.cuh's BSDF against render/materials.py's)."""
    import chip_smoke

    result = chip_smoke.check_photon_gather(cuda_device)  # raises on any disagreement
    assert result["ms"] > 0.0 and result["dense"]["fullest_bucket"] > 64


def _gather_case(dev, n, seed=21):
    """A seeded photon cloud's map and n lanes in it with a Substitute's
    parameters (the dense check's construction at small widths)."""
    from zyg_tpu_torch.render import materials as M
    from zyg_tpu_torch.render.integrator import photon as photon_mod
    from zyg_tpu_torch.scene.loader import load_scene_dict

    g = torch.Generator(device="cpu").manual_seed(seed)
    m = 20_000
    p = (torch.rand((m, 3), generator=g) - 0.5) * 0.6
    wi = torch.nn.functional.normalize(torch.randn((m, 3), generator=g), dim=1)
    pmap = photon_mod.build_map(p.to(dev), wi.to(dev), torch.rand((m, 3), generator=g).to(dev),
                                torch.ones(m, dtype=torch.bool, device=dev), 0.05, m)
    pos = ((torch.rand((n, 3), generator=g) - 0.5) * 0.6).to(dev)
    nrm = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=1).to(dev)
    scene = load_scene_dict({
        "materials": [{"name": "a", "rendering": {"Substitute": {"roughness": 0.5}}},
                      {"name": "l", "rendering": {"Light": {"emittance": {"value": 1.0}}}}],
        "entities": [{"type": "Prop", "shape": {"type": "Rectangle"}, "materials": ["a"]},
                     {"type": "Light", "shape": {"type": "Sphere"}, "materials": ["l"]}]}, dev)
    params = M.gather(scene.materials, torch.zeros(n, dtype=torch.int32, device=dev),
                      medium_ior=torch.ones(n, device=dev), features=scene.mat_features)
    return pmap, params, pos, nrm


@pytest.mark.parametrize("case", [0, 1, 31, 33, 129, 257, 4096, "all inactive"])
def test_photon_gather_launch_shapes(cuda_device, case):
    import chip_smoke
    from zyg_tpu_torch import ops
    from zyg_tpu_torch.ops import photon as op

    n = 4096 if case == "all inactive" else case
    pmap, params, pos, nrm = _gather_case(cuda_device, n)
    active = torch.full((n,), case != "all inactive", dtype=torch.bool, device=cuda_device)
    args = (pmap.p, pmap.wi, pmap.alpha, pmap.cell_start, params, pos, nrm, nrm, nrm, active,
            0.05, 20_000, 64)
    before = ops.launch_counts()["photon_gather"]
    got = op.photon_gather(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["photon_gather"] == before + (n > 0)
    assert got.shape == (n, 3) and got.device.type == "cuda"
    if case == "all inactive":
        assert not got.any()
    chip_smoke._compare_gather(got, op.photon_gather_plain(*args))


def test_photon_gather_full_lanes_beside_empty_ones(cuda_device):
    """Lanes whose 8 cells all hold more than the cap (512 visits each) in
    the warps of lanes that visit nothing or do not gather: a group's
    trips and its early exit must not leak into its neighbours'."""
    import chip_smoke
    from zyg_tpu_torch.ops import photon as op
    from zyg_tpu_torch.render.integrator import photon as photon_mod

    n, m = 96, 4000
    _, params, _, nrm = _gather_case(cuda_device, n)
    g = torch.Generator(device="cpu").manual_seed(41)
    centre = torch.tensor([0.013, 0.021, 0.037])
    p = centre + (torch.rand((m, 3), generator=g) - 0.5) * 0.2
    wi = torch.nn.functional.normalize(torch.randn((m, 3), generator=g), dim=1)
    pmap = photon_mod.build_map(p.to(cuda_device), wi.to(cuda_device),
                                torch.rand((m, 3), generator=g).to(cuda_device),
                                torch.ones(m, dtype=torch.bool, device=cuda_device), 0.05, m)
    # far from every photon, but for the full lanes near the cloud's centre
    pos = 5.0 + torch.arange(n, dtype=torch.float32)[:, None] * 0.3 + torch.zeros(3)
    full = [0, 5, 17, 37, 63]
    pos[full] = centre + torch.tensor([[0.0, 0.0, 0.0], [0.004, 0.0, 0.0], [0.0, 0.003, 0.0],
                                       [0.0, 0.0, 0.002], [0.001, 0.002, 0.003]])
    active = torch.ones(n, dtype=torch.bool)
    active[[1, 6, 36, 62]] = False
    pos, active = pos.to(cuda_device), active.to(cuda_device)
    args = (pmap.p, pmap.wi, pmap.alpha, pmap.cell_start, params, pos, nrm, nrm, nrm, active,
            0.05, m, 64)
    v = chip_smoke.gather_visits(pmap.p, pmap.wi, pmap.cell_start, pos, nrm, active, 0.05, 64)
    assert v["most_lane_visits"] == 512 and v["visits"] == 512 * len(full)
    got, want = op.photon_gather(*args), op.photon_gather_plain(*args)
    torch.cuda.synchronize()
    chip_smoke._compare_gather(got, want)
    assert (want[full].amax(dim=1) > 0).all()
    assert not got[[k for k in range(n) if k not in full]].any()


def test_photon_gather_repeated_cells(cuda_device):
    """Every lane on a point where the sphere's cells repeat on one axis or
    more (lo == hi there: points near a cell's centre, where float32
    rounding keeps pos - r and pos + r in one cell), so the kernel's scan
    skips cells as the plain version does."""
    import chip_smoke
    from zyg_tpu_torch.ops import photon as op

    n = 512
    pmap, params, pos, nrm = _gather_case(cuda_device, n)
    rad, inv_cell = op.scalars(0.05, 1)[:2]
    # cell centres and their float32 neighbours in the cloud, kept where
    # they repeat (the same arithmetic as op._cells)
    centres = (torch.arange(-3, 3, dtype=torch.float32) + 0.5) * 0.1
    cand = torch.cat([centres])
    for _ in range(4):
        cand = torch.cat([cand, torch.nextafter(cand, cand + 1), torch.nextafter(cand, cand - 1)])
    cand = torch.unique(cand)
    rep = cand[torch.floor((cand - rad) * inv_cell) == torch.floor((cand + rad) * inv_cell)]
    assert rep.numel() > 0
    g = torch.Generator(device="cpu").manual_seed(43)
    pick = rep[torch.randint(0, rep.numel(), (n, 3), generator=g)]
    axes = torch.rand((n, 3), generator=g) < 0.5
    axes[torch.arange(n), torch.randint(0, 3, (n,), generator=g)] = True  # one axis at least
    pos = torch.where(axes.to(cuda_device), pick.to(cuda_device), pos).contiguous()
    dup = torch.stack([d for d, _ in op._cells(pos, rad, inv_cell)], dim=1)
    assert dup.any(dim=1).all()
    active = torch.ones(n, dtype=torch.bool, device=cuda_device)
    args = (pmap.p, pmap.wi, pmap.alpha, pmap.cell_start, params, pos, nrm, nrm, nrm, active,
            0.05, 20_000, 64)
    got, want = op.photon_gather(*args), op.photon_gather_plain(*args)
    torch.cuda.synchronize()
    chip_smoke._compare_gather(got, want)
    assert (want.amax(dim=1) > 0).any()


def test_photon_gather_refuses_what_it_cannot_take(cuda_device):
    from zyg_tpu_torch.ops import photon as op

    pmap, params, pos, nrm = _gather_case(cuda_device, 64)
    active = torch.ones(64, dtype=torch.bool, device=cuda_device)
    args = [pmap.p, pmap.wi, pmap.alpha, pmap.cell_start, params, pos, nrm, nrm, nrm, active,
            0.05, 20_000, 64]
    with pytest.raises(ValueError, match="rough glass"):
        op.photon_gather(*args[:4], {**params, "features": {"rough_glass"}}, *args[5:])
    bad = list(args)
    bad[5] = pos.double()
    with pytest.raises(ValueError, match="float32"):
        op.photon_gather(*bad)
    bad = list(args)
    bad[6] = nrm.t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        op.photon_gather(*bad)
    bad = list(args)
    bad[3] = pmap.cell_start[:-1]
    with pytest.raises(ValueError, match="shape"):
        op.photon_gather(*bad)


def test_lt_splat_matches_plain_on_card(cuda_device):
    """The camera splat on the first bounce of a 512x512 pass of
    cornell_particles.take: connections exact, RGB within rtol 4e-6 (the
    atomics add in another order)."""
    import chip_smoke

    result = chip_smoke.check_lt_splat(cuda_device)  # raises on any disagreement
    assert result["ms"] > 0.0 and result["adds"] > 0


def _splat_case(dev, n, seed=27):
    """n seeded lanes over five material kinds (three Substitutes, smooth
    glass and a Light: only the Substitutes can add) onto 64 pixels."""
    from zyg_tpu_torch.render import materials as M
    from zyg_tpu_torch.scene.loader import load_scene_dict

    mats = [{"name": "white", "rendering": {"Substitute": {"roughness": 1.0}}},
            {"name": "gold", "rendering": {"Substitute": {"color": [0.9, 0.6, 0.2],
                                                          "roughness": 0.15, "metallic": 1.0}}},
            {"name": "plastic", "rendering": {"Substitute": {"roughness": 0.35}}},
            {"name": "glass", "rendering": {"Glass": {"ior": 1.5}}},
            {"name": "lamp", "rendering": {"Light": {"emittance": {"value": 5.0}}}}]
    scene = load_scene_dict({"materials": mats, "entities": [
        {"type": "Light" if m["name"] == "lamp" else "Prop", "shape": {"type": "Rectangle"},
         "materials": [m["name"]], "transformation": {"position": [i, 0, 0]}}
        for i, m in enumerate(mats)]}, dev)
    g = torch.Generator(device="cpu").manual_seed(seed)

    def unit():
        return torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=1).to(dev)

    nrm = unit()
    geo = torch.nn.functional.normalize(nrm + 0.3 * unit(), dim=1)
    mat = torch.randint(0, 5, (n,), generator=g, dtype=torch.int32).to(dev)
    params = M.gather(scene.materials, mat, medium_ior=torch.ones(n, device=dev),
                      features=scene.mat_features)
    tp = (torch.rand((n, 3), generator=g) * 2.0).to(dev)
    cam_pdf = torch.empty(n).exponential_(generator=g).to(dev)
    ids = torch.randint(0, 64, (n,), generator=g).to(dev)
    connect = (torch.rand(n, generator=g) < 0.8).to(dev)
    blocked = (torch.rand(n, generator=g) < 0.2).to(dev)
    return [params, unit(), unit(), nrm, geo, tp, cam_pdf, ids, connect, blocked]


@pytest.mark.parametrize("n", [0, 1, 31, 33, 129, 4096])
def test_lt_splat_launch_shapes(cuda_device, n):
    from zyg_tpu_torch import ops
    from zyg_tpu_torch.ops import lt_splat as op

    args = _splat_case(cuda_device, n)
    out = [(torch.zeros((64, 4), device=cuda_device),
            torch.zeros(1, dtype=torch.int64, device=cuda_device)) for _ in range(2)]
    before = ops.launch_counts()["lt_splat"]
    op.lt_splat(*args, *out[0])
    op.lt_splat_plain(*args, *out[1])
    torch.cuda.synchronize()
    assert ops.launch_counts()["lt_splat"] == before + (n > 0)
    assert int(out[0][1]) == int(out[1][1])
    if n == 4096:
        assert int(out[0][1]) > n // 4 and float(out[0][0].max()) > 0.0
    assert not out[0][0][:, 3].any()
    # the Substitutes' BSDF: shade_core.cuh's rounding against
    # render/materials.py's, a few ulps; then the atomics' order
    torch.testing.assert_close(out[0][0], out[1][0], rtol=4e-6,
                               atol=4e-6 * float(out[1][0].abs().max()) + 1e-30)


@pytest.mark.parametrize("n", [4096, 262145])
@pytest.mark.parametrize("case", ["64 pixels", "one pixel", "none connect"])
def test_lt_splat_contention(cuda_device, n, case):
    """Many adds a pixel: the seeded lanes onto 64 pixels (~1,600 adds a
    pixel at 262,145 lanes), every lane onto pixel 0, or no lane
    connecting (nothing added, count 0). The count exact; each pixel
    within rtol 2e-4 of the float64 sum of the plain version's
    contributions: ~40 % of the lanes add, in an order the atomics
    choose, and a float32 sum of k terms rounds up to k/2 ulps away from
    the exact one (the rtol 4e-6 of the launch shapes holds at ~25 adds a
    pixel, not here)."""
    from zyg_tpu_torch.ops import lt_splat as op

    args = _splat_case(cuda_device, n)
    if case == "one pixel":
        args[7] = torch.zeros_like(args[7])
    elif case == "none connect":
        args[8] = torch.zeros_like(args[8])
    splat = torch.zeros((64, 4), device=cuda_device)
    count = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    op.lt_splat(*args, splat, count)
    conn, contrib = op.contributions(*args[:7], args[8], args[9])
    torch.cuda.synchronize()
    assert int(count) == int(conn.sum())
    if case == "none connect":
        assert int(count) == 0 and not splat.any()
        return
    assert int(count) > n // 4 and not splat[:, 3].any()
    want = torch.zeros((64, 3), dtype=torch.float64, device=cuda_device)
    want.index_add_(0, args[7], contrib.double())
    if case == "one pixel":
        assert not splat[1:].any()
    torch.testing.assert_close(splat[:, :3].double(), want, rtol=2e-4,
                               atol=2e-4 * float(want.abs().max()))


def test_lt_splat_refuses_what_it_cannot_take(cuda_device):
    from zyg_tpu_torch.ops import lt_splat as op

    args = _splat_case(cuda_device, 64)
    splat = torch.zeros((64, 4), device=cuda_device)
    count = torch.zeros(1, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="rough glass"):
        op.lt_splat({**args[0], "features": {"rough_glass"}}, *args[1:], splat, count)
    bad = list(args)
    bad[5] = args[5].double()
    with pytest.raises(ValueError, match="float32"):
        op.lt_splat(*bad, splat, count)
    bad = list(args)
    bad[1] = args[1].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        op.lt_splat(*bad, splat, count)
    with pytest.raises(ValueError, match="shape"):
        op.lt_splat(*args, torch.zeros((64, 3), device=cuda_device), count)
    with pytest.raises(ValueError, match="int64"):
        op.lt_splat(*args, splat, count.int())


def test_particle_pass_card_vs_cpu(cuda_device):
    """Four 32x32 passes of cornell_particles.take through the Driver on
    the card and on the CPU: rays within 0.5 %, the golden gate."""
    import chip_smoke
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file

    take = chip_smoke._particles_take((32, 32), 4)
    scene = load_scene_file(take.scene_filename)
    drivers = [Driver(take, scene, device=d) for d in (cuda_device, "cpu")]
    imgs = [d.render_frame() for d in drivers]
    assert abs(drivers[0].rays_traced - drivers[1].rays_traced) <= 5e-3 * drivers[1].rays_traced
    chip_smoke._golden_gate(imgs[0], imgs[1], "particles 32x32x4", "card test")


@pytest.fixture(scope="module")
def bvh2_arenas(cuda_device):
    """sparks' point arena over its frame-0 shutter and hairball's curve
    arena on the card, with each take's camera rays in the prop's object
    space (chip_smoke._walk_lanes): {"points": ..., "curves": ...}."""
    import chip_smoke
    from zyg_tpu_torch.scene.types import ShapeType

    out = {}
    for kind, take, res, shape in (("points", "sparks.take", (64, 36), ShapeType.POINTS),
                                   ("curves", "hairball.take", (48, 48), ShapeType.CURVES)):
        scene, _, root, o, d, tl = chip_smoke._walk_lanes(cuda_device, take, res, 41, shape)
        out[kind] = (scene.points if kind == "points" else scene.curves, root, o, d, tl)
    return out


def _bvh2_case(lanes, n, case):
    """n of the lanes (repeated where n exceeds them), with the case's
    twist: "no walk" (every root -1), "short" (tmax 0.5: before every
    hit), "nan" (one ray with a NaN direction), "ends" (shutter times 0
    and 1), "incoherent" (n seeded rays from the tree's root box in
    seeded directions, chip_smoke._incoherent_lanes)."""
    import chip_smoke

    arena, root, o, d, tl = lanes
    if case == "incoherent":
        root, o, d, tl = chip_smoke._incoherent_lanes(o.device, arena.node_rows, int(root[0]), n,
                                                      43)
        return arena, root, o, d, tl, torch.full((n,), 1e30, device=o.device)
    idx = torch.arange(n, device=o.device) % max(o.shape[0], 1)
    root, o, d, tl = (root[idx].contiguous(), o[idx].contiguous(), d[idx].contiguous(),
                      tl[idx].contiguous())
    tmax = torch.full((n,), 1e30, device=o.device)
    if case == "no walk":
        root = torch.full_like(root, -1)
    elif case == "short":
        tmax = torch.full_like(tmax, 0.5)
    elif case == "nan" and n:
        d[n // 2, 1] = float("nan")
    elif case == "ends":
        tl = (torch.arange(n, device=o.device) % 2).to(torch.float32)
    return arena, root, o, d, tl, tmax


@pytest.mark.parametrize("case", ["plain", "no walk", "short", "nan", "ends", "incoherent"])
@pytest.mark.parametrize("n", [0, 1, 31, 129, 2305, "resident+1"])
@pytest.mark.parametrize("kind", ["points", "curves"])
def test_walk_launch_shapes(cuda_device, bvh2_arenas, kind, n, case):
    """The point and curve walks at small widths, and at one lane more than
    a pass of their resident grid (whose warps refill their threads from
    the lane counter), with the twists of _bvh2_case, closest and any-hit,
    bit-exact against the plain walks on the card; each call launches its
    kernel once (none at 0 lanes)."""
    from zyg_tpu_torch import ops
    from zyg_tpu_torch.ops import curves, points
    from zyg_tpu_torch.scene import curves as crv
    from zyg_tpu_torch.scene import points as pts

    n = _lanes(n, f"zyg_{kind}_resident_lanes")
    arena, root, o, d, tl, tmax = _bvh2_case(bvh2_arenas[kind], n, case)
    for any_hit in (False, True):
        before = ops.launch_counts()[kind]
        if kind == "points":
            k = points.walk(arena, root, o, d, 0.0, tmax, time=tl, any_hit=any_hit)
            p = pts.traverse(arena, root, o, d, 0.0, tmax, time=tl, any_hit=any_hit)
        else:
            k = curves.walk(arena, root, o, d, 0.0, tmax, any_hit=any_hit)
            p = crv.traverse(arena, root, o, d, 0.0, tmax, any_hit=any_hit)
        torch.cuda.synchronize()
        assert ops.launch_counts()[kind] == before + (1 if n else 0)
        for a, b in zip(k, p):
            if a.dtype.is_floating_point:  # a NaN equals a NaN here
                a, b = torch.nan_to_num(a, nan=-7.0), torch.nan_to_num(b, nan=-7.0)
            assert torch.equal(a, b)
        if case in ("no walk", "short"):
            assert not bool((k[-1] >= 0).any())


def test_walks_refuse_what_they_cannot_take(cuda_device, bvh2_arenas):
    """A CUDA tensor launches the kernel or raises: a moving arena without
    shutter times, rows off a 16-byte boundary, the wrong dtypes."""
    import dataclasses

    from zyg_tpu_torch.ops import curves, points

    arena, root, o, d, tl = bvh2_arenas["points"]
    tmax = torch.full((o.shape[0],), 1e30, device=cuda_device)
    with pytest.raises(ValueError, match="shutter times"):
        points.walk(arena, root, o, d, 0.0, tmax)
    rows = arena.node_rows
    shifted = torch.empty(rows.numel() + 1, dtype=rows.dtype, device=cuda_device)[1:].view(rows.shape)
    shifted.copy_(rows)
    with pytest.raises(ValueError, match="16-byte aligned"):
        points.walk(dataclasses.replace(arena, node_rows=shifted), root, o, d, 0.0, tmax, time=tl)
    with pytest.raises(ValueError, match="int32"):
        points.walk(arena, root.long(), o, d, 0.0, tmax, time=tl)
    carena, croot, co, cd, _ = bvh2_arenas["curves"]
    ctmax = torch.full((co.shape[0],), 1e30, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        curves.walk(carena, croot, co.double(), cd, 0.0, ctmax)
    with pytest.raises(ValueError, match="segment rows"):
        curves.walk(dataclasses.replace(carena, seg_rows=carena.seg_rows[:, :36].contiguous()),
                    croot, co, cd, 0.0, ctmax)


@pytest.mark.parametrize("take, res, depth", [("sparks.take", (64, 36), None),
                                              ("hairball.take", (48, 48), 4)])
def test_point_and_hair_renders_card_vs_cpu(cuda_device, take, res, depth):
    """sparks (kernel 6 and the moving point walk) and hairball (the general
    body, the curve walk and the hair BSDF) through the Driver on the card
    and on the CPU at 4 spp: the golden gate, rays within 0.5 %."""
    import chip_smoke
    from zyg_tpu_torch.render.driver import Driver
    from zyg_tpu_torch.scene.loader import load_scene_file

    t = chip_smoke._take(take, res, 4)
    if depth is not None:
        t.integrator.max_depth_surface = depth
    scene = load_scene_file(t.scene_filename, "cpu", *t.cameras[0].frame_interval(0))
    drivers = [Driver(t, scene, device=dev) for dev in (cuda_device, "cpu")]
    imgs = [drv.render_frame() for drv in drivers]
    assert abs(drivers[0].rays_traced - drivers[1].rays_traced) <= 5e-3 * drivers[1].rays_traced
    chip_smoke._golden_gate(imgs[0], imgs[1], f"{take} {res[0]}x{res[1]}x4", "card test")
