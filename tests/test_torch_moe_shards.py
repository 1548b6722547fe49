"""The MoE's routing over the data shards of a batch, on the CPU in one
process: what each rank of a mesh computes for its own tokens, held
against the whole batch's routing.

A batch of 2 x 31 tokens (62: not a multiple of 3 or 4) of a reduced
float32 olmoe-1b-7b (width / 16: 8 experts, top-2) is split into dp
contiguous shards of its tokens (``np.array_split``), dp in 1-4. Each
shard is routed alone by ``moe_route`` with ``before``, the assignments
per expert of the shards ahead of it (as ``_moe_router``'s counts give
them), and must give the whole batch's (gates, experts, slots, kept),
assignment for assignment: against the port's ``moe_route`` over the whole
batch and against the JAX package's routing (its lines,
``test_torch_moe._jax_route``, jitted), at the config's capacity factor
(C = 20: nothing drops on these inputs), at 0.5 (C = 8 slots for 15.5
assignments an expert: the slots run out within later shards, which a
shard counting its own tokens alone would keep) and at 8.0 (nothing
drops). The aux loss from the shards' summed
``_moe_router`` sums equals the whole batch's, the port's and the JAX
package's, within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_moe import _jax_route, _moe_params
from repro.models import layers as JL
from repro_torch.models import layers as L

ARCH = "olmoe-1b-7b"
SHAPE = (2, 31)                 # batch, tokens: 62, no multiple of 3 or 4
CAPACITY = {"config": None, "drops": 0.5, "no-drop": 8.0}
SHARDS = (1, 2, 3, 4)


def _inputs():
    jc, pc, jp, tp = _moe_params(ARCH, "float32")
    x = np.random.default_rng(11).standard_normal(
        (*SHAPE, pc.d_model)).astype(np.float32)
    return jc, pc, jp, tp, x


def _bounds(T: int, dp: int) -> list[tuple[int, int]]:
    cuts = np.cumsum([0] + [len(a) for a in np.array_split(np.arange(T),
                                                             dp)])
    return list(zip(cuts[:-1], cuts[1:]))


def _shard_routes(probs, cfg, C, dp: int, counts: bool = True):
    """Each shard's ``moe_route``, ``before`` its predecessors' counts (or
    none with ``counts=False``), concatenated in shard order."""
    E = cfg.num_experts
    before = torch.zeros(E, dtype=torch.int64)
    parts = []
    for lo, hi in _bounds(probs.shape[0], dp):
        out = L.moe_route(probs[lo:hi], cfg, C, before if counts else None)
        parts.append(out)
        before = before + torch.bincount(out[1], minlength=E)
    return [torch.cat(ts) for ts in zip(*parts)]


@pytest.mark.parametrize("cf", list(CAPACITY), ids=list(CAPACITY))
@pytest.mark.parametrize("dp", SHARDS)
def test_shard_routing_equals_the_whole_batch(dp, cf):
    jc, pc, jp, tp, x = _inputs()
    T, k = SHAPE[0] * SHAPE[1], pc.experts_per_token
    factor = CAPACITY[cf] or pc.moe_capacity_factor
    C = L.moe_capacity(T, pc, factor)
    xt = torch.from_numpy(x).reshape(T, -1)
    probs = torch.softmax((xt @ tp["router"]).float(), dim=-1)
    want = L.moe_route(probs, pc, C)
    got = _shard_routes(probs, pc, C, dp)
    for name, g, w in zip(("gates", "experts", "slots", "kept"), got, want):
        assert torch.equal(g, w), (name, dp, cf)
    e_j, keep_j, pos_j = jax.jit(lambda p, x: _jax_route(p, x, jc, C))(
        jp, jnp.asarray(x))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(e_j))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(pos_j))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(keep_j))
    # the shards' counts as the router gives them: the experts' bincounts
    for lo, hi in _bounds(T, dp):
        _, counts, _ = L._moe_router(xt[lo:hi], tp["router"], pc)
        assert torch.equal(counts[0], torch.bincount(
            want[1][lo * k:hi * k], minlength=pc.num_experts))
    dropped = ~want[3]
    assert bool(dropped.any()) == (cf == "drops"), cf
    if cf == "drops" and dp > 1:
        # drops that straddle the shards: alone, the later shards keep
        alone = _shard_routes(probs, pc, C, dp, counts=False)[3]
        assert bool((alone & dropped).any())


@pytest.mark.parametrize("dp", SHARDS)
def test_aux_loss_from_the_shards_sums(dp):
    jc, pc, jp, tp, x = _inputs()
    T, E = SHAPE[0] * SHAPE[1], pc.num_experts
    xt = torch.from_numpy(x).reshape(T, -1)
    sums = sum(L._moe_router(xt[lo:hi], tp["router"], pc)[2]
               for lo, hi in _bounds(T, dp))
    aux = float(E * torch.sum((sums[0] / T) * (sums[1] / T)))
    _, whole = L.moe_apply(tp, torch.from_numpy(x), pc)
    _, jaux = jax.jit(lambda p, x: JL.moe_apply(p, x, jc))(
        jp, jnp.asarray(x))
    for want in (float(whole), float(jaux)):
        assert abs(aux - want) <= 1e-6 * abs(want), (aux, want)
