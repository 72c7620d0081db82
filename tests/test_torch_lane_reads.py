"""The lane-read tables of kernels 5 and 6 (ops/surface.py and
ops/surface_v2.py LANE_READS / UNIFORM_READS), by which chip_smoke.py bounds
each kernel with the bytes its lanes need, against the plain versions on the
CPU: an input (or uniform column) replaced by other values on every lane
outside the lane sets its entry names (chip_smoke.lane_sets) leaves every
output the checks compare bit for bit unchanged. Those outputs: alive,
depth, the ray count, nee_active, o, d, mis_o, mis_n and the radiance sums
on every lane; throughput, bxdf_pdf and reg_alpha on the lanes that stay
alive; the shadow ray, its tmax and the NEE value on the lanes whose NEE
sample is active. Lanes: the card checks' own (chip_smoke._surface_lanes)
over the bench trefoil (kernel 5) and the CI textured trefoil under its sky
dome (kernel 6), 4,096 of them, at depth 4 with and without caustics and at
depth 2 with NEE only.
"""

import functools
import operator

import pytest
import torch

SETTINGS = [(4, True, False), (4, False, False), (2, True, True)]
N = 4096


def _perturbed(x, mask, g, lo=None, hi=None):
    """x with the lanes of mask replaced: booleans flipped, integers drawn
    from [lo, hi), floats from [-2, 2)."""
    x = x.clone()
    k = int(mask.sum())
    if k == 0:
        return x
    if x.dtype == torch.bool:
        x[mask] = ~x[mask]
    elif x.dtype == torch.int32:
        x[mask] = torch.randint(lo, hi, (k,) + x.shape[1:], generator=g, dtype=torch.int32)
    else:
        x[mask] = torch.rand((k,) + x.shape[1:], generator=g) * 4 - 2
    return x


def _changed(r1: dict, r2: dict) -> list:
    live, nee = r2["alive"], r2["nee_active"]
    bad = []
    for k in r2:
        a, b = r1[k], r2[k]
        if k in ("throughput", "bxdf_pdf", "reg_alpha"):
            a, b = a[live], b[live]
        elif k in ("shadow_o", "shadow_d", "shadow_tmax", "nee"):
            a, b = a[nee], b[nee]
        if not torch.equal(a, b):
            bad.append(k)
    return bad


def _check_table(kernel, mod, fn, st, ua, ub, settings, tables, ranges):
    import chip_smoke

    g = torch.Generator().manual_seed(11)
    ref = fn(st, ua, ub)
    sets = chip_smoke.lane_sets(kernel, st, ua, ref, settings[0], settings[2], tables)
    # the draw reaches every lifecycle the bound counts
    classes = chip_smoke.lane_classes(sets, ref)
    assert min(classes["dead"], classes["missed"], classes["nee_reached"],
               classes["nee_active"], classes["sample_failed"]) > 0, classes

    def outside(names):
        return ~functools.reduce(operator.or_, (sets[k] for k in names))

    assert set(mod.LANE_READS) == set(st)
    for name, names in mod.LANE_READS.items():
        st2 = dict(st, **{name: _perturbed(st[name], outside(names), g, *ranges.get(name, ()))})
        assert not _changed(fn(st2, ua, ub), ref), (name, _changed(fn(st2, ua, ub), ref))
    col = {"ua": 0, "ub": 0}
    for arr, cols, names in mod.UNIFORM_READS:
        u = {"ua": ua, "ub": ub}[arr].clone()
        m = outside(names)
        u[m, col[arr]:col[arr] + cols] = torch.rand((int(m.sum()), cols), generator=g)
        col[arr] += cols
        r = fn(st, u, ub) if arr == "ua" else fn(st, ua, u)
        assert not _changed(r, ref), (arr, names, _changed(r, ref))


@pytest.fixture(scope="module")
def trefoil():
    import chip_smoke
    from zyg_tpu_torch.ops import surface

    scene = chip_smoke._trefoil(torch.device("cpu"))
    return scene, surface.pack_mesh_tables(scene)


@pytest.mark.parametrize("settings", SETTINGS)
def test_surface_lane_reads(trefoil, settings):
    import chip_smoke
    from zyg_tpu_torch.ops import surface

    scene, tables = trefoil
    st, ua, ub = chip_smoke.surface_inputs(scene, tables,
                                           chip_smoke._surface_lanes(N, torch.device("cpu")))
    ranges = {"mslot": (0, tables.mtab.shape[0]), "light_id": (-1, tables.ltab.shape[0])}
    _check_table("surface", surface,
                 lambda st, ua, ub: surface.surface_plain(tables, st, ua, ub, *settings),
                 st, ua, ub, settings, tables, ranges)


@pytest.mark.parametrize("settings", SETTINGS)
def test_surface_v2_lane_reads(settings):
    import chip_smoke
    from zyg_tpu_torch.ops import surface_v2
    from zyg_tpu_torch.render.integrator.ptmis import PtmisSettings

    dev = torch.device("cpu")
    _, scene = chip_smoke._textured(dev, ci=True)
    body = surface_v2.make_mesh_fused_body_v2(
        scene, PtmisSettings(max_depth=settings[0], caustics=settings[1], nee_only=settings[2]))
    st, ua, ub, *_ = body.inputs(chip_smoke._surface_lanes(N, dev))
    _check_table("surface_v2", surface_v2,
                 lambda st, ua, ub: surface_v2.surface_v2_plain(st, ua, ub, *settings),
                 st, ua, ub, settings, None, {"mat_kind": (0, 3)})
