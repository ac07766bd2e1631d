"""The port's ``inference_vae`` against the JAX package's
(``train/inference_vae.py``), and the soft-intro presets: one trained
state (random weights drawn from ``jax.eval_shape``'s shapes, 32^2,
decoder ngf 4) written as the JAX package's ``sivae.msgpack`` and as the
port's ``sivae.pt``, two validation conditions at batch 1, three styles
each, the JAX latents injected (fold ``bi * 131 + k`` of ``seed + 101``):

- under the reference ``PerceptualLoss``'s l1 branch and under LPIPS-alex
  (random AlexNet weights and lins, bridged): each image's diversity and
  the mean within 1e-5 relative; the ``FID_real`` / ``FID_fake`` /
  ``styles`` files of both packages equal byte for byte in count and
  name;
- the ``sivae`` and ``end2end_sivae`` presets equal the JAX package's.

The JAX package's ``run`` draws a template state with flax's eager init;
here its model's ``init`` gives the drawn state instead (no init is
compiled)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_segmentation_tpu.core.config import parse_config as jparse
from semantic_segmentation_tpu.models.extractors import \
    AlexNetFeatures as JAlex
from semantic_segmentation_tpu.models.vae.sivae import \
    SoftIntroVAE as JSoftIntroVAE
from semantic_segmentation_tpu.train import inference_vae as jinf
from semantic_segmentation_tpu.utils.serialization import save_pytree
from semantic_segmentation_torch.core.config import parse_config
from semantic_segmentation_torch.models.extractors import (ALEX_WIDTHS,
                                                           AlexNetFeatures)
from semantic_segmentation_torch.train import inference_vae as tinf
from semantic_segmentation_torch.train import train_vae as ttv
from semantic_segmentation_torch.utils.bridge import load_flax, load_sivae_flax
from tests.test_torch_sivae_nets import random_tree, random_variables

SIZE, NGF, STYLES = 32, 4, 3
ARGV = ["--data.synthetic=true", f"--data.image_size={SIZE}",
        "--data.n_train=2", "--data.n_val=2", "--data.n_test=0",
        "--data.batch_size=1", "--model.compute_dtype=float32",
        f"--model.ngf={NGF}", "--run.name=sivae-test"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(save dir, JAX model whose ``init`` returns the drawn state, the
    port's model) with the same state written in both formats."""
    root = tmp_path_factory.mktemp("sivae")
    jm = JSoftIntroVAE(latent_dim=8, output_nc=3, ngf=NGF,
                       netG=f"unet_{SIZE}", dtype=jnp.float32)
    v = random_tree(jax.eval_shape(lambda: jm.init(jax.random.key(0),
                                                   SIZE)), seed=21)
    jm.init = lambda rng, image_size: v
    run = root / "sivae-test"
    save_pytree({"enc_params": v["enc"]["params"],
                 "enc_stats": v["enc"]["batch_stats"],
                 "dec_params": v["dec"]["params"], "dec_stats": {},
                 "arch": v["arch"]}, str(run / "sivae.msgpack"))
    cfg = parse_config(ARGV + [f"--run.save_dir={root}", "--run.device=cpu"])
    vae = load_sivae_flax(ttv.build_model(cfg, "cpu"), v)
    torch.save(ttv.checkpoint_state(vae), run / "sivae.pt")
    return root, jm, vae


def jax_latents(cfg, n_batches: int):
    root = jax.random.key(cfg.run.seed + 101)
    return [[torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(root, bi * 131 + k), (1, 8))))
        for k in range(STYLES)] for bi in range(n_batches)]


@pytest.mark.parametrize("distance", ["l1", "lpips_alex"])
def test_inference_diversity_matches_jax(trained, distance):
    root, jm, vae = trained
    jcfg = jparse(ARGV + [f"--run.save_dir={root}"])
    cfg = parse_config(ARGV + [f"--run.save_dir={root}", "--run.device=cpu"])
    jalex = talex = None
    if distance == "lpips_alex":
        va = random_variables(JAlex(), jnp.zeros((1, SIZE, SIZE, 3)),
                              seed=22)
        rng = np.random.default_rng(23)
        lins = [np.abs(rng.normal(size=(w,))).astype(np.float32)
                for w in ALEX_WIDTHS]
        jalex = (va["params"], lins)
        net = AlexNetFeatures()
        load_flax(net, va["params"])
        talex = (net.eval(), lins)
    want = jinf.run(jcfg, num_styles=STYLES, alex=jalex, model=jm)
    out = root / "sivae-test" / "inference"
    files = {sub: sorted(os.listdir(out / sub))
             for sub in ("FID_real", "FID_fake", "styles")}
    got = tinf.run(cfg, num_styles=STYLES, alex=talex, model=vae,
                   draws=jax_latents(jcfg, 2))
    assert got["images"] == len(want["per_image"]) == 2
    np.testing.assert_allclose(got["per_image"], want["per_image"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["diversity"], want["diversity"],
                               rtol=1e-5)
    assert {sub: sorted(os.listdir(out / sub)) for sub in files} == files
    assert files["styles"] == sorted(f"style{k}_image{i}.png"
                                     for k in range(STYLES)
                                     for i in range(2))
    print(f"inference_vae ({distance}): diversity {got['diversity']:.6f} "
          f"against {want['diversity']:.6f}")


def test_sivae_presets_match_jax():
    for preset in ("sivae", "end2end_sivae"):
        j = jparse([], preset=preset)
        t = parse_config([], preset=preset)
        for section in ("data", "model", "optim", "engine"):
            tj = getattr(t, section).__dict__
            jj = getattr(j, section).__dict__
            for k, v in tj.items():
                assert v == jj[k], (preset, section, k, v, jj[k])
        assert t.run.name == j.run.name
    assert parse_config([], preset="end2end_sivae").engine.hypergrad == \
        "decay_only"
