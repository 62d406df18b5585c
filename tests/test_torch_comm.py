"""The port's collectives (``parallel/comm.py``) in 2 and 4 spawned gloo
ranks on the CPU, held to numpy.

Held: every collective's forward and its backward (its transpose:
``ppermute`` the inverse permutation, ``all_gather`` ``psum_scatter`` and
back, ``psum`` ``psum``, ``all_to_all`` the inverse ``all_to_all``) and
the conjugate pairs the model code uses (``shard_along``/``gather_along``,
``reduce_from``/``copy_to``) exactly, rank by rank; the per-kind counter
of issued collectives; the mesh's axis groups and coordinates. One rank
pool per world size serves the whole module.
"""

import numpy as np
import pytest
import torch

from analytics_zoo_tpu_torch.parallel import comm

SHAPE = (4, 3)


def _ctx(**axes):
    from analytics_zoo_tpu_torch.common.config import MeshConfig
    from analytics_zoo_tpu_torch.common.context import (init_zoo_context,
                                                        reset_zoo_context)

    reset_zoo_context()
    return init_zoo_context(platform="cpu", mesh=MeshConfig(**axes))


def _global(seed, n, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n,) + shape).astype(np.float32),
            rng.standard_normal((n,) + shape).astype(np.float32))


def _run_op(name, seed):
    """Forward and backward of one collective over dp = world; returns
    ``(out, grad, counts)`` as numpy."""
    import torch.distributed as dist

    n = dist.get_world_size()
    _ctx(dp=n)
    r = dist.get_rank()
    xs, _ = _global(seed, n)
    x = torch.tensor(xs[r], requires_grad=True)
    ops = {
        "all_gather": lambda t: comm.all_gather(t, "dp", dim=0, tiled=True),
        "all_gather_stack": lambda t: comm.all_gather(t, "dp", dim=1),
        "psum": lambda t: comm.psum(t, "dp"),
        "psum_scatter": lambda t: comm.psum_scatter(t, "dp", dim=0,
                                                    tiled=True),
        "all_to_all": lambda t: comm.all_to_all(t, "dp", 0, 1),
        "ppermute": lambda t: comm.ppermute(t, "dp", comm.ring_perm(n)),
        "ppermute_partial": lambda t: comm.ppermute(t, "dp", [(0, n - 1)]),
        "shard_along": lambda t: comm.shard_along(t, "dp", 0),
        "gather_along": lambda t: comm.gather_along(t, "dp", 0),
        "reduce_from": lambda t: comm.reduce_from(t, "dp"),
        "copy_to": lambda t: comm.copy_to(t, "dp"),
    }
    comm.reset_collective_counts()
    out = ops[name](x)
    g = torch.tensor(np.random.default_rng(seed + 100 + r)
                     .standard_normal(tuple(out.shape)).astype(np.float32))
    (grad,) = torch.autograd.grad(out, x, g)
    return out.detach().numpy(), grad.numpy(), g.numpy(), \
        comm.collective_counts()


def _oracle(name, xs, gs):
    """numpy forward and backward of ``name`` over the stacked per-rank
    inputs ``xs`` and cotangents ``gs`` (lists, rank order)."""
    n = len(xs)
    if name == "all_gather":
        out = [np.concatenate(xs, 0)] * n
        grad = [sum(g[r * SHAPE[0]:(r + 1) * SHAPE[0]] for g in gs)
                for r in range(n)]
    elif name == "all_gather_stack":
        out = [np.stack(xs, 1)] * n
        grad = [sum(g[:, r] for g in gs) for r in range(n)]
    elif name == "psum":
        out = [sum(xs)] * n
        grad = [sum(gs)] * n
    elif name == "psum_scatter":
        b = SHAPE[0] // n
        out = [sum(xs)[r * b:(r + 1) * b] for r in range(n)]
        grad = [np.concatenate(gs, 0)] * n
    elif name == "all_to_all":
        b = SHAPE[0] // n
        out = [np.concatenate([xs[j][r * b:(r + 1) * b] for j in range(n)],
                              1) for r in range(n)]
        w = SHAPE[1]
        grad = [np.concatenate([gs[j][:, r * w:(r + 1) * w]
                                for j in range(n)], 0) for r in range(n)]
    elif name == "ppermute":
        out = [xs[(r - 1) % n] for r in range(n)]
        grad = [gs[(r + 1) % n] for r in range(n)]
    elif name == "ppermute_partial":
        out = [xs[0] if r == n - 1 else np.zeros_like(xs[0])
               for r in range(n)]
        grad = [gs[n - 1] if r == 0 else np.zeros_like(xs[0])
                for r in range(n)]
    elif name == "shard_along":
        b = SHAPE[0] // n
        out = [xs[r][r * b:(r + 1) * b] for r in range(n)]
        grad = [np.concatenate(gs, 0)] * n
    elif name == "gather_along":
        out = [np.concatenate(xs, 0)] * n
        grad = [gs[r][r * SHAPE[0]:(r + 1) * SHAPE[0]] for r in range(n)]
    elif name == "reduce_from":
        out = [sum(xs)] * n
        grad = list(gs)
    elif name == "copy_to":
        out = list(xs)
        grad = [sum(gs)] * n
    return out, grad


KIND = {"all_gather": ("all-gather", "reduce-scatter"),
        "all_gather_stack": ("all-gather", "reduce-scatter"),
        "psum": ("all-reduce", "all-reduce"),
        "psum_scatter": ("reduce-scatter", "all-gather"),
        "all_to_all": ("all-to-all", "all-to-all"),
        "ppermute": ("collective-permute", "collective-permute"),
        "ppermute_partial": ("collective-permute", "collective-permute"),
        "shard_along": (None, "all-gather"),
        "gather_along": ("all-gather", None),
        "reduce_from": ("all-reduce", None),
        "copy_to": (None, "all-reduce")}


@pytest.fixture(scope="module")
def pools():
    made = {}

    def get(world):
        if world not in made:
            made[world] = comm.RankPool(world, device="cpu", timeout_s=300)
        return made[world]

    yield get
    for p in made.values():
        p.close()


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(KIND))
def test_collective_and_its_transpose(pools, world, name):
    res = pools(world).run(_run_op, name, 7)
    xs, _ = _global(7, world)
    got_out = [r[0] for r in res]
    got_grad = [r[1] for r in res]
    gs = [r[2] for r in res]
    want_out, want_grad = _oracle(name, list(xs), gs)
    for r in range(world):
        np.testing.assert_allclose(got_out[r], want_out[r], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got_grad[r], want_grad[r], rtol=1e-6,
                                   atol=1e-6)
    fwd, bwd = KIND[name]
    want = {k: 0 for k in comm.KINDS}
    for k in (fwd, bwd):
        if k is not None:
            want[k] += 1
    assert all(r[3] == want for r in res), (res[0][3], want)


def _mesh_view():
    import torch.distributed as dist

    ctx = _ctx(dp=2, sp=2)
    m = ctx.mesh
    return (dist.get_rank(), m.coords, {a: (m.axis(a).size, m.axis(a).index,
                                            m.axis(a).ranks)
                                        for a in ("dp", "sp", "pp")})


def test_mesh_axis_groups_and_coordinates(pools):
    got = pools(4).run(_mesh_view)
    for rank, coords, axes in got:
        dp, sp = divmod(rank, 2)
        assert coords["dp"] == dp and coords["sp"] == sp
        assert axes["dp"] == (2, dp, (sp, sp + 2))
        assert axes["sp"] == (2, sp, (2 * dp, 2 * dp + 1))
        assert axes["pp"][0] == 1


def _sub_axis_psum():
    """psum over sp inside a dp x sp mesh: sums only the sp line."""
    import torch.distributed as dist

    _ctx(dp=2, sp=2)
    r = dist.get_rank()
    return float(comm.psum(torch.tensor(float(r)), "sp"))


def test_collectives_stay_on_their_axis(pools):
    got = pools(4).run(_sub_axis_psum)
    assert got == [1.0, 1.0, 5.0, 5.0]


def test_trivial_axis_issues_nothing():
    """No job: every axis is trivial, the collectives are identities and
    nothing is counted."""
    from analytics_zoo_tpu_torch.common.context import reset_zoo_context

    _ctx(dp=1)
    try:
        comm.reset_collective_counts()
        x = torch.arange(6.0).reshape(2, 3)
        assert torch.equal(comm.psum(x, "dp"), x)
        assert torch.equal(comm.all_gather(x, "dp", tiled=True), x)
        assert torch.equal(comm.ppermute(x, "dp", [(0, 0)]), x)
        assert comm.axis_size("dp") == 1 and comm.axis_index("dp") == 0
        assert sum(comm.collective_counts().values()) == 0
    finally:
        reset_zoo_context()


def _raises_on_rank(bad):
    import torch.distributed as dist

    if dist.get_rank() == bad:
        raise ValueError("planted")
    return dist.get_rank()


def test_rank_error_names_the_rank_and_closes_the_pool():
    with pytest.raises(comm.RankError, match="rank 1"):
        comm.spawn_ranks(_raises_on_rank, 2, device="cpu", args=(1,))
    pool = comm.RankPool(2, device="cpu", timeout_s=60)
    with pytest.raises(comm.RankError, match="rank 0"):
        pool.run(_raises_on_rank, 0)
    with pytest.raises(comm.RankError, match="closed"):
        pool.run(_raises_on_rank, 5)


@pytest.mark.parametrize("device,cards,world,want", [
    ("cuda", 4, 4, "nccl"), ("cuda", 1, 4, "gloo"), ("cuda", 1, 1, "nccl"),
    ("cpu", 4, 4, "gloo")])
def test_default_backend_follows_the_device(monkeypatch, device, cards,
                                            world, want):
    """NCCL where each rank has a card of its own, else gloo (ranks that
    share a card stage CUDA tensors through host buffers)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert comm.default_backend(device, world) == want


def test_rank_pool_defaults_to_the_card(monkeypatch):
    """Without ``device="cpu"`` the ranks are CUDA ranks: a host with no
    card raises before any process starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        comm.RankPool(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        comm.spawn_ranks(_raises_on_rank, 2, args=(1,))
