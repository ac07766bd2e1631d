"""Three ``end2end_isic224`` engine iterations (ResNet-6 generator, a small
Swin-UNet, the photometric chain, the Jaccard loss) against the JAX
package's engine, every draw injected: the harness and the case are in
``tests/test_torch_isic.py``, which runs the ``end2end_isic`` cases."""
from tests.test_torch_isic import engine_iterations_against_jax


def test_three_iterations_match_jax(tmp_path, monkeypatch):
    engine_iterations_against_jax("isic224_swin", tmp_path, monkeypatch)
