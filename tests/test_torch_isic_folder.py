"""Three ``end2end_isic`` engine iterations from a tiny ISIC-layout folder
of RGB PNGs at ``--model.output_nc=3`` against the JAX package's engine,
every draw injected: the harness and the case are in
``tests/test_torch_isic.py`` (its own file so that its JAX compile runs on
another test worker than the synthetic case's)."""
import pytest

from tests.test_torch_isic import engine_iterations_against_jax


@pytest.mark.parametrize("case", ["isic_rgb_folder"])
def test_three_iterations_match_jax(case, tmp_path, monkeypatch):
    engine_iterations_against_jax(case, tmp_path, monkeypatch)
