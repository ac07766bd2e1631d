"""The port's ``darts`` and ``unroll`` hypergradients on problems with a known
answer, and the rule that no kernel sits on a gradient path.

- The analytic toy of ``tests/test_engine.py`` in float64: inner
  ``0.5 (w - a)^2`` stepped by SGD(eta), outer ``0.5 (w1 - t)^2``; both
  modes give the closed form ``(w1 - t) eta`` (1e-6, relative); roll-back
  replays under the new arch; without it the unrolled weights stay; K = 2
  matches the chain rule by hand; a ``darts`` child with a zero ``v`` adds
  exactly 0 even when its two evaluations differ.
- The conv toy of ``tests/test_program_parity.py:146``, where the direct
  term and the finite difference are both non-zero: three ``darts``
  iterations with K = 2 and roll-back, and three ``unroll`` ones, against
  the JAX package's ``BilevelEngine`` built once for the file; arch within
  1e-5, inner weights within 1e-5 of their largest magnitude.
- Three ``end2end_nas`` (``unroll``) iterations of the real nets against
  the JAX engine, as ``tests/test_torch_engine_modes.py`` sets out.
- The wrappers with float inputs refuse one that requires grad, on the CPU
  too (their plain path): no kernel has a backward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from semantic_segmentation_tpu.core.config import parse_config as jparse
from semantic_segmentation_tpu.core.optim import adam_torch as jadam_torch
from semantic_segmentation_tpu.engine.bilevel import \
    BilevelEngine as JBilevelEngine
from semantic_segmentation_tpu.engine.bilevel import \
    InnerProblem as JInnerProblem
from semantic_segmentation_tpu.train.common import load_splits as jload_splits
from semantic_segmentation_torch.core.optim import adam_torch
from semantic_segmentation_torch.engine.bilevel import (BilevelEngine,
                                                        InnerProblem)
from semantic_segmentation_torch.ops import augment, conv, image
from tests.test_torch_engine_modes import (ARGV as MODES_ARGV,  # noqa: F401
                                           jit_build_engine_and_state,
                                           rank_pool,
                                           three_iterations_against_jax)

ETA, ALR, W0, TARGET = 0.1, 0.05, 0.5, 1.7


class _Weights(torch.nn.Module):
    def __init__(self, **tensors):
        super().__init__()
        for k, v in tensors.items():
            self.register_parameter(k, torch.nn.Parameter(v))


def _pick(params, name, default):
    return params[name] if params is not None and name in params else default


def make_toy(hypergrad, roll_back=False, unroll_steps=1):
    mod = _Weights(w=torch.tensor([W0], dtype=torch.float64))
    arch = {"a": torch.zeros(1, dtype=torch.float64)}

    def loss_p(batch, draws, params=None, generator=None):
        w = _pick(params, "p", dict(mod.named_parameters()))["w"]
        a = _pick(params, "arch", arch)["a"]
        return 0.5 * torch.sum((w - a) ** 2)

    def outer_loss(params, val_batch):
        w = _pick(params, "p", dict(mod.named_parameters()))["w"]
        return 0.5 * torch.sum((w - TARGET) ** 2)

    prob = InnerProblem("p", loss_p, mod, torch.optim.SGD(mod.parameters(),
                                                          lr=ETA), ETA)
    eng = BilevelEngine([prob], arch, torch.optim.SGD(list(arch.values()),
                                                      lr=ALR),
                        outer_loss, unroll_steps=unroll_steps,
                        roll_back=roll_back, hypergrad=hypergrad,
                        arch_children=("p",))
    return eng, mod


def _batches(K=1):
    return [{"p": None}] * K


@pytest.mark.parametrize("mode", ["unroll", "darts"])
def test_toy_hypergrad_matches_closed_form(mode):
    eng, _ = make_toy(mode)
    metrics = eng.engine_step(_batches(), None)
    w1 = W0 - ETA * (W0 - 0.0)
    expected = -ALR * (w1 - TARGET) * ETA
    np.testing.assert_allclose(eng.arch["a"].item(), expected, rtol=1e-6)
    np.testing.assert_allclose(metrics["arch_grad_norm"].item(),
                               abs((w1 - TARGET) * ETA), rtol=1e-6)
    assert "outer_loss" in metrics


@pytest.mark.parametrize("mode", ["unroll", "darts"])
def test_toy_rollback_replays_with_new_arch(mode):
    eng, mod = make_toy(mode, roll_back=True)
    metrics = eng.engine_step(_batches(), None)
    a_new = eng.arch["a"].item()
    assert a_new != 0.0
    np.testing.assert_allclose(mod.w.item(), W0 - ETA * (W0 - a_new),
                               rtol=1e-12)
    assert "replay_loss_p" in metrics


def test_toy_no_rollback_keeps_unrolled_params():
    eng, mod = make_toy("unroll", roll_back=False)
    metrics = eng.engine_step(_batches(), None)
    np.testing.assert_allclose(mod.w.item(), W0 - ETA * W0, rtol=1e-12)
    assert "replay_loss_p" not in metrics


def test_toy_unroll_k2_matches_manual():
    eng, _ = make_toy("unroll", roll_back=False, unroll_steps=2)
    eng.engine_step(_batches(2), None)
    # two SGD steps toward a = 0: w2 = W0 (1 - eta)^2, dw2/da = 1 -
    # (1 - eta)^2
    w2 = W0 * (1 - ETA) ** 2
    expected = -ALR * (w2 - TARGET) * (1 - (1 - ETA) ** 2)
    np.testing.assert_allclose(eng.arch["a"].item(), expected, rtol=1e-6)


def test_darts_child_with_zero_v_adds_exactly_zero():
    """A ``darts`` child whose ``v`` is exactly 0 adds exactly 0 to the
    hypergradient, even when its two evaluations at that one point differ
    (as a backward with atomic adds makes them on the card): here every
    evaluation of the child's loss is scaled by 1 + 1e-9 x its call count,
    and the outer loss reads the child's weights with a zero gradient."""
    mod = _Weights(w=torch.tensor([W0], dtype=torch.float64))
    arch = {"a": torch.zeros(1, dtype=torch.float64)}
    calls = []

    def loss_p(batch, draws, params=None, generator=None):
        w = _pick(params, "p", dict(mod.named_parameters()))["w"]
        a = _pick(params, "arch", arch)["a"]
        calls.append(1)
        return 0.5 * torch.sum((w - a) ** 2) * (1.0 + 1e-9 * len(calls))

    def outer_loss(params, val_batch):
        w = _pick(params, "p", dict(mod.named_parameters()))["w"]
        return torch.sum(w * 0.0)

    prob = InnerProblem("p", loss_p, mod, torch.optim.SGD(mod.parameters(),
                                                          lr=ETA), ETA)
    eng = BilevelEngine([prob], arch, torch.optim.SGD(list(arch.values()),
                                                      lr=ALR),
                        outer_loss, hypergrad="darts", arch_children=("p",))
    metrics = eng.engine_step(_batches(), None)
    assert len(calls) == 4     # the unroll, two evaluations, the replay
    assert metrics["arch_grad_norm"].item() == 0.0
    assert eng.arch["a"].item() == 0.0


# -- the conv toy against the JAX engine ---------------------------------

CONV_K, CONV_LR, CONV_ARCH_LR = 2, 0.05, 1e-2


def _conv_data():
    rng = np.random.default_rng(3)
    f = np.float32
    return {"k0": (rng.normal(size=(3, 3, 1, 2)) * 0.3).astype(f),
            "a0": (rng.normal(size=(2,)) * 0.1).astype(f),
            "xs": rng.normal(size=(3, CONV_K, 2, 8, 8, 1)).astype(f),
            "ys": rng.normal(size=(3, CONV_K, 2, 8, 8, 2)).astype(f),
            "xv": rng.normal(size=(2, 8, 8, 1)).astype(f),
            "yv": rng.normal(size=(2, 8, 8, 2)).astype(f)}


def _run_jax_conv_toy(mode: str, data):
    def conv_j(x, k):
        return jax.lax.conv_general_dilated(
            x, k, (1, 1), [(1, 1), (1, 1)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    def train_loss(params, state, arch, batch, rng):
        x, y = batch
        pred = conv_j(x, params["k"]) * (1.0 + arch[0])
        return jnp.mean((pred - y) ** 2), {}

    def outer_loss(state, arch, val_batch):
        x, y = val_batch
        pred = conv_j(x, state.params["w"]["k"]) * (1.0 + arch[1])
        return jnp.mean((pred - y) ** 2)

    eng = JBilevelEngine(
        [JInnerProblem("w", train_loss, optax.sgd(CONV_LR), CONV_LR)],
        outer_loss, jadam_torch(CONV_ARCH_LR, 0.5), unroll_steps=CONV_K,
        roll_back=True, hypergrad=mode, darts_epsilon=0.01,
        arch_children=("w",))
    k0 = jnp.asarray(data["k0"])
    st = eng.init(params={"w": {"k": k0}}, stats={"w": {}},
                  opts={"w": optax.sgd(CONV_LR).init({"k": k0})},
                  arch=jnp.asarray(data["a0"]))
    out = []
    for s in range(3):
        st, m = eng.engine_step(
            st, {"w": (jnp.asarray(data["xs"][s]), jnp.asarray(data["ys"][s]))},
            (jnp.asarray(data["xv"]), jnp.asarray(data["yv"])),
            jax.random.key(s))
        out.append((np.asarray(st.arch), np.asarray(st.params["w"]["k"]),
                    float(m["arch_grad_norm"])))
    return out


@pytest.fixture(scope="module")
def jax_conv_toy():
    """The JAX engine's trajectories, one build per mode for the file."""
    data = _conv_data()
    return data, {m: _run_jax_conv_toy(m, data) for m in ("darts", "unroll")}


@pytest.mark.parametrize("mode", ["darts", "unroll"])
def test_conv_toy_matches_jax_engine(jax_conv_toy, mode):
    data, runs = jax_conv_toy
    mod = _Weights(k=torch.from_numpy(
        data["k0"].transpose(3, 2, 0, 1).copy()))            # OIHW
    arch = {"a": torch.from_numpy(data["a0"].copy())}

    def nchw(x):
        return torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(x, -1, -3)))

    def train_loss(batch, draws, params=None, generator=None):
        x, y = batch
        k = _pick(params, "w", dict(mod.named_parameters()))["k"]
        a = _pick(params, "arch", arch)["a"]
        return ((F.conv2d(x, k, padding=1) * (1.0 + a[0]) - y) ** 2).mean()

    def outer_loss(params, val_batch):
        x, y = val_batch
        k = _pick(params, "w", dict(mod.named_parameters()))["k"]
        a = _pick(params, "arch", arch)["a"]
        return ((F.conv2d(x, k, padding=1) * (1.0 + a[1]) - y) ** 2).mean()

    eng = BilevelEngine(
        [InnerProblem("w", train_loss, mod,
                      torch.optim.SGD(mod.parameters(), lr=CONV_LR),
                      CONV_LR)],
        arch, adam_torch(list(arch.values()), CONV_ARCH_LR, 0.5), outer_loss,
        unroll_steps=CONV_K, roll_back=True, hypergrad=mode,
        darts_epsilon=0.01, arch_children=("w",))
    xs, ys = nchw(data["xs"]), nchw(data["ys"])
    val = (nchw(data["xv"]), nchw(data["yv"]))
    worst = {"arch": 0.0, "k": 0.0, "norm": 0.0}
    for s, (arch_j, k_j, norm_j) in enumerate(runs[mode]):
        m = eng.engine_step([{"w": (xs[s, u], ys[s, u])}
                             for u in range(CONV_K)], val)
        assert norm_j > 0
        k_t = mod.k.detach().numpy().transpose(2, 3, 1, 0)
        worst["arch"] = max(worst["arch"],
                            np.abs(arch["a"].numpy() - arch_j).max())
        worst["k"] = max(worst["k"],
                         np.abs(k_t - k_j).max() / np.abs(k_j).max())
        worst["norm"] = max(worst["norm"],
                            abs(m["arch_grad_norm"].item() - norm_j) / norm_j)
        np.testing.assert_allclose(arch["a"].numpy(), arch_j, rtol=0,
                                   atol=1e-5, err_msg=f"arch, step {s}")
        np.testing.assert_allclose(k_t, k_j, rtol=0,
                                   atol=1e-5 * np.abs(k_j).max(),
                                   err_msg=f"inner weights, step {s}")
        np.testing.assert_allclose(m["arch_grad_norm"].item(), norm_j,
                                   rtol=1e-3)
    print(f"conv toy, {mode}: largest gaps {worst}")


# -- the real nets under end2end_nas -------------------------------------

@pytest.fixture(scope="module")
def jax_start():
    """The JAX initial state (its init jitted: the eager one took 39 s of
    this file's setup) and the splits."""
    jcfg = jparse(MODES_ARGV, preset="end2end_jsrt")
    _, state, _, _ = jit_build_engine_and_state(jcfg, jax.random.key(0))
    return jax.device_get(state), jload_splits(jcfg)


def test_three_unroll_iterations_match_jax(jax_start, rank_pool):
    # the first iteration also on two gloo ranks (test_torch_engine_modes)
    three_iterations_against_jax("unroll_nas", *jax_start, pool=rank_pool)


# -- no kernel on a gradient path -----------------------------------------

def _grad_case(name: str):
    x = torch.rand(2, 16, 16, 1)
    if name == "warp_affine":
        return lambda t: augment.warp_affine_batch(
            t, torch.eye(3).expand(2, 3, 3).contiguous()), x
    if name == "equalize_uint8":
        return lambda t: image.equalize_gamma_chain(t, 0.5), x
    w = torch.rand(4, 4, 8, 16)
    return lambda t: conv.conv_down4(t, w), torch.rand(2, 16, 16, 8)


@pytest.mark.parametrize("name", ["warp_affine", "equalize_uint8",
                                  "conv_down4"])
def test_wrappers_refuse_inputs_that_require_grad_on_cpu(name):
    fn, x = _grad_case(name)
    fn(x)
    with pytest.raises(RuntimeError, match="requires grad"):
        fn(x.clone().requires_grad_(True))
