"""Each CUDA kernel of the port against its plain torch version on the card,
at the main path's shapes (the checks of chip_smoke.py phase 3), the
persistent kernels (shade, surface, surface_v2, traverse) at the launch
shapes their grid-stride and ray-fetch loops must get right, sobol_block
and the per-pixel flush at small widths, isect on material_test's tables,
and the general body (torch around isect and sobol_block) on the card
against the CPU at 0, 1, 31 and 129 lanes; the tracking walks, with the
interaction walk's emissive variant on the fire path's lanes, the
general body over fire.scene, kernel 6 on hero.take's and portal.take's
first bounce, isect on portal.scene's tables, the filtered flush at
the Cornell path's width and at small widths in its three footprint
rules, the traversal over forest.take's 144 instances and its
motion-blur variant (kAnim) at seeded shutter times, the photon
gather on caustics_photons.take's first bounce, a dense map and small
widths, and the lighttracer's camera splat on cornell_particles.take's
first bounce and on seeded lanes at small widths, with the particle pass
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
                                    "traverse_anim"])
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
    variant on a moving copy of the forest at seeded shutter times."""
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
             "traverse_anim": chip_smoke.check_traverse_anim}[kernel]
    result = check(cuda_device)  # raises on any disagreement
    assert result["ms"] > 0.0


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


@pytest.mark.parametrize("n", [0, 1, 31, 129])
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


@pytest.mark.parametrize("case", [0, 1, 31, 129, 4096, "all inactive"])
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


@pytest.mark.parametrize("n", [0, 1, 31, 129, 4096])
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
