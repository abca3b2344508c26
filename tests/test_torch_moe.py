"""The port's Mixture-of-Experts layers against the JAX package, on the
CPU.

``MoEMLP`` with ``dispatch="capacity"`` (ample capacity, and a capacity
that drops assignments) and ``"ragged"`` (dropless; the grouped product
one expert at a time on the CPU), and ``MoELayer`` over expert Linears:
the JAX layers' weights (``convert.from_jax_state_dict``), the same
inputs, outputs, the aux loss and gradients at the JAX tests' f32
tolerances (tests/test_moe.py:46, :152, :161-163, :190); the ragged route
processes every token when all of them pick one expert; one
``ShardedTrainer`` run of the MoE LM of ``bench.py``'s ``bench_moe`` at a
tiny size against the JAX trainer; the expert-parallel refusals.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.incubate.nn import MoELayer as JMoELayer
from paddle_tpu.incubate.nn import MoEMLP as JMoEMLP
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import from_jax_state_dict, to_numpy_state_dict
from paddle_tpu_torch.incubate.nn import MoELayer, MoEMLP


def _state(m):
    return {k: np.asarray(v.value) for k, v in m.state_dict().items()}


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _moe_pair(seed=0, **kw):
    paddle.seed(seed)
    jm = JMoEMLP(16, 32, **kw)
    return jm, from_jax_state_dict(_state(jm), MoEMLP(16, 32, device="cpu",
                                                      **kw))


def _fwd_bwd(jm, tm, x):
    """Outputs, aux loss and the gradients of sum(out^2) + aux."""
    jx = paddle.to_tensor(x, stop_gradient=False)
    jo = jm(jx)
    (paddle.sum(jo * jo) + jm.aux_loss).backward()
    tx = torch.from_numpy(x).requires_grad_()
    to = tm(tx)
    ((to * to).sum() + tm.aux_loss).backward()
    return jx, jo, tx, to


@pytest.mark.parametrize("dispatch,cf,top_k", [
    ("capacity", 1.25, 2), ("capacity", 0.25, 2), ("capacity", 100.0, 4),
    ("ragged", 1.25, 2), ("ragged", 1.25, 1)])
def test_moe_mlp_matches_jax(dispatch, cf, top_k):
    """Forward at tests/test_moe.py:152's 1e-5 and gradients at
    :161-163's rtol 1e-4 / atol 1e-5; capacity 0.25 drops assignments
    (rows of zeros where a token lost both), as the JAX layer does."""
    jm, tm = _moe_pair(n_experts=4, top_k=top_k, capacity_factor=cf,
                       dispatch=dispatch)
    jx, jo, tx, to = _fwd_bwd(jm, tm, _x((2, 8, 16)))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo.numpy()),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.aux_loss.item(),
                               float(jm.aux_loss.numpy()), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), rtol=1e-4,
                               atol=1e-5)
    jp = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jp[n].grad.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=n)
    if cf == 0.25:
        rows = np.abs(to.detach().numpy().reshape(-1, 16)).sum(1)
        assert (rows == 0).any() and (rows > 0).any()


def test_ragged_never_drops_and_equals_capacity_at_ample_capacity():
    """Every token to expert 0 (tests/test_moe.py:190's tolerance): the
    ragged route runs them all through expert 0's FFN; and with ample
    capacity the capacity route gives the ragged route's outputs."""
    paddle.seed(1)
    jm = JMoEMLP(8, 16, n_experts=4, top_k=1, dispatch="ragged",
                 normalize_topk=False, activation="relu")
    tm = MoEMLP(8, 16, n_experts=4, top_k=1, dispatch="ragged",
                normalize_topk=False, activation="relu", device="cpu")
    w = np.zeros((8, 4), np.float32)
    w[:, 0] = 10.0
    jm.gate.weight.set_value(paddle.to_tensor(w))
    from_jax_state_dict(_state(jm), tm)
    x = np.abs(_x((2, 16, 8), 1))
    out = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(out, np.asarray(jm(paddle.to_tensor(x))
                                               .numpy()),
                               rtol=1e-4, atol=1e-5)
    tok = x.reshape(-1, 8)
    logits = tok @ w
    z = np.exp(logits - logits.max(1, keepdims=True))
    gate = (z / z.sum(1, keepdims=True))[:, 0]
    h = np.maximum(tok @ tm.w1.detach().numpy()[0]
                   + tm.b1.detach().numpy()[0, 0], 0.0)
    want = (h @ tm.w2.detach().numpy()[0] + tm.b2.detach().numpy()[0, 0]) \
        * gate[:, None]
    np.testing.assert_allclose(out.reshape(-1, 8), want, rtol=1e-4,
                               atol=1e-5)
    cap = MoEMLP(8, 16, n_experts=4, top_k=1, capacity_factor=100.0,
                 normalize_topk=False, activation="relu", device="cpu")
    cap.load_state_dict(tm.state_dict())
    np.testing.assert_allclose(cap(torch.from_numpy(x)).detach().numpy(),
                               out, rtol=1e-5, atol=1e-5)


def test_moe_layer_matches_jax():
    paddle.seed(2)
    jl = JMoELayer(16, [jnn.Linear(16, 16) for _ in range(4)], top_k=2)
    tl = from_jax_state_dict(_state(jl), MoELayer(
        16, [tnn.Linear(16, 16, device="cpu") for _ in range(4)], top_k=2,
        device="cpu"))
    x = _x((2, 8, 16), 3)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jo = jl(jx)
    paddle.sum(jo).backward()
    tx = torch.from_numpy(x).requires_grad_()
    to = tl(tx)
    to.sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo.numpy()),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tl.aux_loss.item(),
                               float(jl.aux_loss.numpy()), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), rtol=1e-4,
                               atol=1e-5)
    jp = dict(jl.named_parameters())
    for n, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jp[n].grad.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=n)


class _JaxMoELM(jnn.Layer):
    """bench.py's bench_moe LM at the bench's CPU size: Embedding, blocks
    of LayerNorm + ragged MoEMLP (top-2) with a residual, the tied head
    through the fused CE (V 4096 here, so the chunked route runs)."""

    def __init__(self, V, d, f, E, n):
        super().__init__()
        self.embed = jnn.Embedding(V, d)
        self.norms = jnn.LayerList([jnn.LayerNorm(d) for _ in range(n)])
        self.moes = jnn.LayerList([JMoEMLP(d, f, n_experts=E, top_k=2,
                                           dispatch="ragged")
                                   for _ in range(n)])

    def loss(self, ids, labels):
        from paddle_tpu.ops.fused_ce import fused_lm_loss
        h = self.embed(ids)
        for norm, moe in zip(self.norms, self.moes):
            h = h + moe(norm(h))
        return fused_lm_loss(h, self.embed.weight.t(), labels)


class _MoELM(torch.nn.Module):
    def __init__(self, V, d, f, E, n):
        super().__init__()
        self.embed = tnn.Embedding(V, d, device="cpu")
        self.norms = tnn.LayerList([tnn.LayerNorm(d, device="cpu")
                                    for _ in range(n)])
        self.moes = tnn.LayerList([MoEMLP(d, f, n_experts=E, top_k=2,
                                          dispatch="ragged", device="cpu")
                                   for _ in range(n)])

    def loss(self, ids, labels):
        from paddle_tpu_torch.ops.fused_ce import fused_lm_loss
        h = self.embed(ids)
        for norm, moe in zip(self.norms, self.moes):
            h = h + moe(norm(h))
        return fused_lm_loss(h, self.embed.weight.t(), labels)


def test_moe_lm_trainer_matches_jax():
    """Two AdamW steps of the dropless MoE LM through ``ShardedTrainer``
    against the JAX trainer: losses at 1e-5, parameters as in
    tests/test_torch_train.py."""
    from paddle_tpu.parallel import init_mesh
    from paddle_tpu.parallel.mesh import set_mesh
    from paddle_tpu.parallel.train import ShardedTrainer as JaxTrainer

    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ShardedTrainer

    dims = (4096, 32, 64, 4, 2)
    paddle.seed(4)
    jm = _JaxMoELM(*dims)
    tm = from_jax_state_dict(_state(jm), _MoELM(*dims))
    rng = np.random.default_rng(0)
    ids, labels = rng.integers(0, 4096, (2, 16)), rng.integers(0, 4096,
                                                               (2, 16))
    lr, steps = 1e-3, 2
    mesh = init_mesh((1, 1, 1), ("dp", "sep", "mp"))
    try:
        jt = JaxTrainer(jm, paddle.optimizer.AdamW(
            learning_rate=lr, parameters=jm.parameters()),
            lambda m, i, l: m.loss(i, l), mesh, {})
        with mesh:
            want = [float(jt.train_step(ids, labels).numpy())
                    for _ in range(steps)]
    finally:
        set_mesh(None)
    tt = ShardedTrainer(tm, AdamW(learning_rate=lr,
                                  parameters=tm.parameters()),
                        lambda m, i, l: m.loss(torch.as_tensor(i),
                                               torch.as_tensor(l)))
    got = [tt.train_step(ids, labels).item() for _ in range(steps)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jstate = _state(jm)
    for n, p in to_numpy_state_dict(tm).items():
        np.testing.assert_allclose(p, jstate[n], rtol=1e-5, atol=3e-6,
                                   err_msg=n)


def test_expert_parallel_routes_refuse_naming_item_13():
    from paddle_tpu_torch.distributed import moe_utils

    tm = MoEMLP(16, 32, n_experts=4, dispatch="ragged", device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        tm.ep_plan(None)
    with pytest.raises(NotImplementedError, match="item 13"):
        MoELayer(16, [tnn.Linear(16, 16, device="cpu")], group=object(),
                 device="cpu")
    for fn, args in ((moe_utils.global_scatter, (None, None, None)),
                     (moe_utils.global_gather, (None, None, None)),
                     (moe_utils.dispatch_tokens, (None, None, 4, 2)),
                     (moe_utils.combine_tokens, (None, None, None))):
        with pytest.raises(NotImplementedError, match="item 13"):
            fn(*args)
    with pytest.raises(ValueError, match="dispatch"):
        MoEMLP(16, 32, n_experts=4, dispatch="dense", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MoEMLP(16, 32, n_experts=4)
