"""Each CUDA kernel of the port against its plain torch version on the card,
at the main path's shapes (the checks of chip_smoke.py phase 3), the
persistent kernels (shade, traverse) at the launch shapes their grid-stride
and ray-fetch loops must get right, sobol_block and the per-pixel flush at
small widths. Skipped without a card. This file
imports no jax, so it also runs on a machine without the JAX package:

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
                                    "surface_v2"])
def test_kernel_matches_plain_on_card(cuda_device, kernel):
    import chip_smoke

    check = {"sobol_block": chip_smoke.check_sobol, "isect": chip_smoke.check_isect,
             "accum": chip_smoke.check_accum, "shade": chip_smoke.check_shade,
             "surface": chip_smoke.check_surface, "traverse": chip_smoke.check_traverse,
             "surface_v2": chip_smoke.check_surface_v2}[kernel]
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
