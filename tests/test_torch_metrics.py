"""The port's evaluation protocol against the JAX package's
(``ops/metrics.py``) on the same logits: binary and 3-class Dice (the
background dropped), ISIC's Jaccard, the dispatch and ``evaluate_dataset``,
within 1e-6. The logits include exact zeros, where sigmoid gives 0.5 and
the strict ``> 0.5`` threshold decides, and all-empty masks (Dice 1)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_tpu.ops import metrics as jmetrics
from semantic_segmentation_torch.ops import metrics

TOL = 1e-6


def _case(n_classes: int, seed: int, empty: bool = False):
    """NHWC logits with a share of exact zeros, and NHWC (C = 1) masks."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((3, 16, 16, n_classes)).astype(np.float32)
    logits[rng.random(logits.shape) < 0.2] = 0.0
    if n_classes > 1:   # ties in the argmax too
        logits[:, :4, :4] = 0.0
    mask = rng.integers(0, max(n_classes, 2), (3, 16, 16, 1)).astype(np.int32)
    if empty:
        logits[...] = -3.0
        mask[...] = 0
    return logits, mask


def _port(logits, mask):
    return (torch.from_numpy(logits).permute(0, 3, 1, 2),
            torch.from_numpy(mask).permute(0, 3, 1, 2))


@pytest.mark.parametrize("n_classes,empty", [(1, False), (1, True),
                                             (3, False)])
def test_eval_batch_dice_matches_jax(n_classes, empty):
    logits, mask = _case(n_classes, seed=n_classes, empty=empty)
    ref = float(jmetrics.eval_batch_dice(jnp.asarray(logits),
                                         jnp.asarray(mask), n_classes))
    lt, mt = _port(logits, mask)
    got = float(metrics.eval_batch_dice(lt, mt, n_classes))
    assert abs(got - ref) <= TOL, (got, ref)
    # NHW masks give the same
    assert abs(float(metrics.eval_batch_dice(lt, mt[:, 0], n_classes))
               - got) == 0.0
    if empty:
        assert got == pytest.approx(1.0)


def test_threshold_at_zero_logits():
    # sigmoid(0) = 0.5 is not > 0.5: an all-zero logit map predicts nothing
    logits = np.zeros((2, 8, 8, 1), np.float32)
    mask = np.ones((2, 8, 8, 1), np.int32)
    ref = float(jmetrics.eval_batch_dice(jnp.asarray(logits),
                                         jnp.asarray(mask)))
    got = float(metrics.eval_batch_dice(*_port(logits, mask)))
    assert abs(got - ref) <= TOL and got < 1e-6


@pytest.mark.parametrize("seed", [0, 1])
def test_eval_batch_jaccard_and_dispatch_match_jax(seed):
    logits, mask = _case(1, seed=10 + seed)
    lj, mj = jnp.asarray(logits), jnp.asarray(mask)
    lt, mt = _port(logits, mask)
    ref = float(jmetrics.eval_batch_jaccard(lj, mj))
    got = float(metrics.eval_batch_jaccard(lt, mt))
    assert abs(got - ref) <= TOL, (got, ref)
    for metric in ("dice", "jaccard"):
        r = float(jmetrics.eval_batch_score(lj, mj, 1, metric))
        g = float(metrics.eval_batch_score(lt, mt, 1, metric))
        assert abs(g - r) <= TOL, (metric, g, r)


@pytest.mark.parametrize("n_classes", [1, 3])
def test_evaluate_dataset_matches_jax(n_classes):
    batches = [_case(n_classes, seed=20 + i) for i in range(3)]
    w = np.random.default_rng(5).standard_normal(
        (1, 1, 1, n_classes)).astype(np.float32)

    def apply_j(image):       # a fixed "net": logits from the inputs
        return image * jnp.asarray(w)

    def apply_t(image):
        return image * torch.from_numpy(w).permute(0, 3, 1, 2)

    ref = jmetrics.evaluate_dataset(
        apply_j, [(jnp.asarray(x[..., :1]), jnp.asarray(m))
                  for x, m in batches], n_classes)
    got = metrics.evaluate_dataset(
        apply_t, [_port(x[..., :1], m) for x, m in batches], n_classes)
    assert abs(got - ref) <= TOL, (got, ref)
