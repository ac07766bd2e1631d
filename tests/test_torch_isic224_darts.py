"""One ``end2end_isic224`` engine iteration under the preset's own
``darts`` hypergradient (ResNet-6 generator, a small Swin-UNet, the
photometric chain, the Jaccard loss) against the JAX package's engine,
every draw injected, and against the port's ``decay_only`` iteration from
the same state: the harness and the case are in
``tests/test_torch_isic.py``."""
from tests.test_torch_isic import engine_iterations_against_jax


def test_darts_iteration_matches_jax_and_decay_only(tmp_path, monkeypatch):
    engine_iterations_against_jax("isic224_swin_darts", tmp_path, monkeypatch)
