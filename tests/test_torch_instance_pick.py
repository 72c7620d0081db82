"""The instance pick of the plain walk (ops/traverse.py traverse_plain)
against the JAX package's `intersect_instances` (zyg_tpu/scene/trimesh.py
`dense_pick`), where the pick is delicate: a 36-row table (two of the JAX
pick's 32-row chunks) with four clusters of five identical instances
(the same box, so rays that start inside a cluster enter all five at
entry t 0), each member hidden from one ray class in turn, beside
scattered instances of two meshes, static and moving (a cluster whose
quaternions' dot product is negative, one whose start and end rows are
equal, and moving scattered rows), at shutter times that include 0 and
1. The card's kernel is held to this plain walk (tests/test_torch_cuda.py).

- Hit ids exact on every lane (static) or on 99.9 % of the lanes
  (moving: torch and XLA round acos and sin an ulp apart), t within rtol
  2e-5 (u and v within 2e-5 absolute too) / 1e-5; any-hit results alike.
- In both packages a ray that hits a cluster hits its first member
  visible to the ray's class: the smallest index wins a tie.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

RAY_MAX_T = np.float32(2.14748313e9)
CLUSTERS = ([-1.2, 0.0, 0.0], [1.2, 0.0, 0.0], [0.0, 1.2, 0.0], [0.0, -1.2, 0.4])
MEMBERS = 5  # identical instances a cluster; member m < 3 is hidden from class m
N = 2048


def _instances(moving: bool, seed: int = 31) -> list[dict]:
    """Four clusters of identical sphere instances (props 10c + m + 1),
    then 16 scattered spheres and cubes (props 100 + k). Moving: cluster
    1 turns from 170 to 190 degrees about y (the quaternions' dot product
    is negative) and steps along x, cluster 2 repeats its start row as its
    end row, every third scattered instance moves."""
    from zyg_tpu_torch.scene.loader import rotation_matrix_from_euler_degrees as rot

    rng = np.random.default_rng(seed)
    out = []
    for c, centre in enumerate(CLUSTERS):
        base = dict(mesh=0, rot=rot([20.0 * c, 170.0 if c == 1 else 35.0 * c, 0.0]),
                    pos=np.float32(centre), scale=np.full(3, 0.6, np.float32))
        if moving and c == 1:
            base.update(rot1=rot([20.0, 190.0, 0.0]),
                        pos1=np.float32(centre) + np.float32([0.1, 0.0, 0.0]),
                        scale1=np.full(3, 0.55, np.float32))
        if moving and c == 2:
            base.update(rot1=base["rot"], pos1=base["pos"], scale1=base["scale"])
        for m in range(MEMBERS):
            out.append(dict(base, prop=10 * c + m + 1,
                            vis=tuple(k != m for k in range(3))))
    for k in range(16):
        angles = rng.uniform(-180.0, 180.0, 3)
        pos = rng.uniform(-2.5, 2.5, 3).astype(np.float32)
        scale = rng.uniform(0.2, 0.5, 3).astype(np.float32)
        ins = dict(prop=100 + k, mesh=k % 2, rot=rot(angles), pos=pos, scale=scale,
                   vis=tuple(bool(v) for v in rng.random(3) > 0.15))
        if moving and k % 3 == 0:
            ins.update(rot1=rot(angles + rng.uniform(-60.0, 60.0, 3)),
                       pos1=(pos + rng.uniform(-0.3, 0.3, 3)).astype(np.float32),
                       scale1=(scale * rng.uniform(0.8, 1.2, 3)).astype(np.float32))
        out.append(ins)
    return out


def _tables(moving: bool):
    from zyg_tpu.scene import trimesh as J
    from zyg_tpu_torch.scene import trimesh as T

    inst = _instances(moving)
    aj = J.build_arena([J.make_sphere_mesh(8, 12), J.make_cube_mesh()])
    ij = J.build_instance_table({"node_rows": np.asarray(aj.node_rows),
                                 "mesh_root": np.asarray(aj.mesh_root)}, inst)
    at, host = T.build_arena([T.make_sphere_mesh(8, 12), T.make_cube_mesh()])
    it = T.build_instance_table(host, inst)
    assert it.has_anim == moving and next(iter(ij.meta))[0] == moving
    for k in ("wmin", "wmax", "trafo", "vis"):
        np.testing.assert_array_equal(getattr(it, k).numpy(), np.asarray(getattr(ij, k)),
                                      err_msg=k)
    return aj, ij, at, it


def _rays(seed: int = 5):
    """A third of the rays start near a cluster's centre (inside all of
    its boxes) in seeded directions, the rest cross the table; shutter
    times with the first 64 lanes at 0 and the next 64 at 1."""
    rng = np.random.default_rng(seed)
    k = N // 3
    o = rng.uniform(-3.0, 3.0, (N, 3)).astype(np.float32)
    tgt = rng.uniform(-1.5, 1.5, (N, 3)).astype(np.float32)
    o[:k] = (np.float32(CLUSTERS)[rng.integers(0, len(CLUSTERS), k)]
             + rng.uniform(-0.08, 0.08, (k, 3))).astype(np.float32)
    tgt[:k] = o[:k] + rng.normal(size=(k, 3)).astype(np.float32)
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    time = rng.random(N).astype(np.float32)
    time[:64], time[64:128] = 0.0, 1.0
    primary = rng.random(N) < 0.5
    return o, d, tgt, time, primary


def _first_visible(prop, col):
    """The prop a cluster hit must carry: the cluster's first member
    visible to column col (per lane); -1 where prop is not a cluster's."""
    c = (prop - 1) // 10
    first = np.where(col == 0, 1, 0)  # member 0 is hidden from the camera column
    return np.where((prop >= 1) & (prop < 10 * len(CLUSTERS)), 10 * c + first + 1, -1)


@pytest.mark.parametrize("moving", [False, True], ids=["static", "moving"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_plain_pick_matches_jax_on_tied_boxes(moving, any_hit):
    from zyg_tpu.scene import trimesh as J
    from zyg_tpu_torch.ops import traverse

    aj, ij, at, it = _tables(moving)
    o, d, tgt, time, primary = _rays()
    # the tie the pick must break: many rays start inside several boxes
    wmin, wmax = it.wmin.numpy(), it.wmax.numpy()
    inside = ((o[:, None] >= wmin[None]) & (o[:, None] <= wmax[None])).all(-1).sum(1)
    assert (inside >= MEMBERS).sum() >= N // 4
    tm = time if moving else None
    tt = torch.from_numpy(time) if moving else None
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    if any_hit:
        tmax = np.linalg.norm(tgt - o, axis=1).astype(np.float32)
        tmax[::7] = 0.0
        ref = np.asarray(jax.jit(lambda o, d, t, s: J.intersect_instances(
            aj, ij, o, d, jnp.float32(0.0), t, "shadow", time=s, any_hit=True).prim >= 0)(
                o, d, tmax, tm))
        out = traverse.intersect_instances(at, it, to, td, 0.0, torch.from_numpy(tmax), "shadow",
                                           any_hit=True, time=tt).numpy()
        assert N // 10 < ref.sum() < N - N // 10
        if moving:
            assert (out == ref).mean() >= 0.999
        else:
            np.testing.assert_array_equal(out, ref)
        return
    tmax = np.full(N, RAY_MAX_T, np.float32)
    tmax[::11] = 0.0
    r = jax.jit(lambda o, d, t, p, s: J.intersect_instances(
        aj, ij, o, d, jnp.float32(0.0), t, "reflection", primary=p, time=s))(
            o, d, tmax, primary, tm)
    t, prim, u, v, prop = (x.numpy() for x in traverse.intersect_instances(
        at, it, to, td, 0.0, torch.from_numpy(tmax), "reflection", torch.from_numpy(primary),
        time=tt))
    rt, rprim, ru, rv, rprop = (np.asarray(x) for x in (r.t, r.prim, r.u, r.v, r.prop))
    col = np.where(primary, 0, 1)
    for p in (prop, rprop):
        want = _first_visible(p, col)
        cluster = want >= 0
        assert cluster.sum() >= N // 5
        np.testing.assert_array_equal(p[cluster], want[cluster])
    assert not (prim[::11] >= 0).any()
    same = (prim == rprim) & (prop == rprop)
    if moving:
        assert same.mean() >= 0.999
        np.testing.assert_allclose(t[same], rt[same], rtol=1e-5)
        return
    np.testing.assert_array_equal(prim, rprim)
    np.testing.assert_array_equal(prop, rprop)
    np.testing.assert_allclose(t, rt, rtol=2e-5, atol=0)
    # a barycentric near an edge is a difference of terms near 1: absolute
    for a, b in ((u, ru), (v, rv)):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)
