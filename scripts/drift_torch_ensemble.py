"""Seed ensemble of the port's long-horizon drift against the JAX engine —
the port of ``scripts/drift_ensemble.py``. It runs on the CPU: the JAX
engine is its reference, and the machine with the card has no JAX.

At 1,000 to 5,000 iterations the final Dice of a batch-2 GAN system is
chaotic: a run perturbed by one float32 ulp already ends points away. So a
gap between the port and the JAX engine at that horizon says something only
beside the spread such perturbations make. For each seed this script runs
four trajectories over one batch stream (the JAX scripts' numpy-seeded
noise pairs, ``fold_in(key(77 + seed), step)`` keys):

  (a) the JAX engine (``build_engine_and_state``: ``decay_only``,
      ``minmax``, no dropout), from its own init at ``key(5 + 1000 seed)``;
  (b) the port's ``BilevelEngine`` on (a)'s initial weights and arch tables
      (bridged by ``utils/bridge.load_flax``), with the augment affines of
      (a)'s U-Net problem re-derived from its keys and injected
      (``tests/test_torch_long_drift.py``);
  (c) (b) with its weights times (1 + 1e-7), about one ulp;
  (d) (b) with its weights times (1 + EPS_MATCHED), the port's own measured
      one-step relative deviation from the JAX engine (``epsilon`` mode),
      so that this control injects what the framework switch injects.

The law of (c) and (d) is the JAX scripts': every parameter of G and D and
the U-Net's whole state (parameters and BN statistics). Each seed's record:
the final Dice of (a), (b), (c), (d) on a held-out set, all four scored by
the JAX package's evaluation (the port's weights bridged back), the gap
|a - b| beside the spreads |b - c| and |b - d|, the first 20 iterations'
largest relative loss gap of (b) from (a) and the largest 25-iteration
windowed relative gap of the U-Net loss. The summary: the gaps and spreads,
their means and maxima, Mann-Whitney p of gap against matched and against
ulp (one-sided, the gap greater), the largest windowed drift.

The port runs on one torch thread, as ``tests/test_torch_long_drift.py``
does (the sums' order depends on the thread count); the JAX side runs with
XLA's CPU defaults, as the JAX script does.

Usage:
  python3 scripts/drift_torch_ensemble.py ensemble [N_STEPS] [SEED ...]
      [--procs P] [--out FILE]       (1,000 steps, seeds 0-6, one process a
      [--controls NAME=EPS,...]       seed, P at a time; FILE default
                                      DRIFT_ENSEMBLE_torch.json; the
                                      controls default ulp and matched)
  python3 scripts/drift_torch_ensemble.py seed N_STEPS SEED  (one seed's
                                      line, what ``ensemble`` starts)
  python3 scripts/drift_torch_ensemble.py epsilon [SEED ...]  (the one-step
                                      deviation EPS_MATCHED was set from)
  python3 scripts/drift_torch_ensemble.py flagship [N_STEPS]  (30 paired
                                      steps at the shipped widths: 128^2,
                                      unet_128, ngf = ndf = 64, base 64)
  python3 scripts/drift_torch_ensemble.py chain [N_STEPS] [SEED]  (one
                                      seed's (a), (b) and (c) with the
                                      flagship's ``uint8_chain`` fakes in
                                      place of ``minmax``: 1,000 steps)
  python3 scripts/drift_torch_ensemble.py learning [--equalized]
      [SIZE ITERS WIDTH]             (the learning validation, each package
                                      from its own init, side by side at a
                                      reduced size: 64 400 16 by default)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from semantic_segmentation_tpu.ops.augment import \
    sample_affine_batch  # noqa: E402
from semantic_segmentation_tpu.ops.metrics import \
    eval_batch_score  # noqa: E402
from semantic_segmentation_torch.core.config import parse_config  # noqa: E402
from semantic_segmentation_torch.train.train_end2end import \
    build_engine  # noqa: E402
from semantic_segmentation_torch.utils.bridge import (  # noqa: E402
    load_flax, state_dict_to_flax)
from scripts.drift_torch_chaos_control import (CPU_ARGV, ULP,  # noqa: E402
                                               noise_batches, scale_state,
                                               windowed_rel)

# The port's one-step relative deviation from the JAX engine at the
# ensemble's configuration, as the JAX script's 6e-7 was its oracle's: the
# losses' largest relative gap after one paired iteration, 5.1e-7 to 9.1e-7
# over seeds 0-6 (``epsilon`` mode, CPU, float32). The parameters' relative
# norm gap after that iteration is larger, 9.0e-6 to 3.1e-3, and it is not
# a scale: in six seeds 4 to 8 of 1.74M elements take an update of the
# other sign, the gap without them is 8.3e-6 to 2.2e-5, and the largest
# gap of a tensor (3.0e-4 to 3.6e-3) is that of a U-Net BN bias, which
# starts at 0 (its one step is its whole value) and which a scaling of the
# weights leaves at 0; in seed 1, 5,825 sign flips make 3.1e-3, 4.8e-4
# without them. ``--controls`` runs other eps beside these.
EPS_MATCHED = 9.1e-7
SEEDS = list(range(7))
FLAGSHIP = {"data.image_size": 128, "model.netG": "unet_128",
            "model.ngf": 64, "model.ndf": 64, "model.base_features": 64}
PROBLEMS = ("netG", "netD", "unet")
CONTROLS = (("ulp", ULP), ("matched", EPS_MATCHED))


def jax_system(flagship: bool = False, fakes: str = "minmax"):
    """The JAX side, built once: (cfg, engine, p2p, seg, jitted
    ``engine_step``), its fakes post-processed by ``fakes``.
    ``init_engine_state`` makes each seed's state on it."""
    from semantic_segmentation_tpu.train.train_end2end import \
        build_engine as build_engine_j
    from tests.test_end2end import tiny_cfg
    over = {"engine.fake_postprocess": fakes,
            "engine.hypergrad": "decay_only", "model.no_dropout": True}
    if flagship:
        over.update(FLAGSHIP)
    cfg = tiny_cfg(tempfile.mkdtemp(prefix="drift_torch_ens_"), **over)
    engine, p2p, seg = build_engine_j(cfg)
    return cfg, engine, p2p, seg, jax.jit(engine.engine_step)


def jax_state(cfg, engine, p2p, seg, seed: int):
    """Seed ``seed``'s JAX initial state (the JAX script's key)."""
    from semantic_segmentation_tpu.train.train_end2end import \
        init_engine_state
    return init_engine_state(cfg, engine, p2p, seg,
                             jax.random.key(5 + 1000 * seed))


def port_argv(flagship: bool = False, fakes: str = "minmax") -> list:
    """The port's options for the JAX side's configuration."""
    return [a for a in CPU_ARGV if not a.startswith(
        "--engine.fake_postprocess=")] + [
        f"--engine.fake_postprocess={fakes}"] + (
        [f"--{k}={v}" for k, v in FLAGSHIP.items()] if flagship else [])


def port_engine(state_j, argv, eps: float = 0.0):
    """The port's engine on ``state_j``'s weights, BN statistics and arch
    tables (fresh optimizers, as the JAX state's), perturbed by ``eps``.
    Returns (engine, seg)."""
    engine, p2p, seg = build_engine(parse_config(argv), "cpu")
    host = jax.device_get(state_j)
    for p in engine.problems:
        load_flax(p.module, host.params[p.name], host.stats[p.name])
    with torch.no_grad():
        for k, v in p2p.arch.items():
            v.copy_(torch.from_numpy(np.array(host.arch[k])))
    scale_state(engine, eps)
    return engine, seg


def affine_fn(size: int):
    """The matrices the JAX ``loss_unet`` samples under ``engine_step(...,
    key)`` in ``decay_only`` (replay rng, K = 1, problem index 2)."""
    @jax.jit
    def affines(key):
        rng_r = jax.random.split(key, 3)[2]
        rng_p = jax.random.fold_in(jax.random.split(rng_r, 1)[0], 2)
        rng_aug = jax.random.split(rng_p, 3)[0]
        return sample_affine_batch(rng_aug, 2, size, size)
    return lambda key: torch.from_numpy(np.array(affines(key)))


def jax_dice(seg_j, params, stats, images, masks) -> float:
    return float(eval_batch_score(
        seg_j.eval_logits_p(jax.tree.map(jnp.asarray, params),
                            jax.tree.map(jnp.asarray, stats),
                            jnp.asarray(images)),
        jnp.asarray(masks), 1, "dice"))


def run_seed(seed: int, n_steps: int, engine_j, state_j, step_j, seg_j,
             size: int, argv, controls=CONTROLS, log=None):
    """Seed ``seed``'s four trajectories over ``n_steps`` iterations from the
    JAX state ``state_j`` (the JAX ``engine_j``, its jitted ``step_j`` and
    ``seg_j`` built by the caller, so that one compile serves every seed).
    ``controls``: (name, eps) of the perturbed port runs. Returns (record,
    losses: {'jax' | 'base' | name: {problem: per-iteration list}})."""
    torch.set_num_threads(1)
    t0 = time.time()
    runs = {"base": port_engine(state_j, argv)}
    for name, eps in controls:
        runs[name] = port_engine(state_j, argv, eps)
    affines = affine_fn(size)
    rng = np.random.default_rng(11 + seed)
    losses = {name: {k: [] for k in PROBLEMS} for name in ("jax", *runs)}
    root = jax.random.key(77 + seed)
    for step in range(n_steps):
        batches = noise_batches(rng, 2, size)
        stack = {n: jax.tree.map(lambda x: jnp.asarray(x)[None], b)
                 for n, b in batches.items()}
        key = jax.random.fold_in(root, step)
        state_j, mj = step_j(state_j, stack, stack["unet"], key)
        for k in PROBLEMS:
            losses["jax"][k].append(float(mj[f"loss_{k}"]))
        torch_batches = [{n: {k: torch.from_numpy(v) for k, v in b.items()}
                          for n, b in batches.items()}]
        draws = {"replay": [{"unet": {"affine": affines(key)}}]}
        for name, (engine, _) in runs.items():
            mt = engine.engine_step(torch_batches, None, draws)
            for k in PROBLEMS:
                losses[name][k].append(float(mt[f"loss_{k}"]))
        if log and (step + 1) % 100 == 0:
            log(f"# seed {seed}: step {step + 1}/{n_steps} "
                f"(t+{time.time() - t0:.0f}s)")

    test_mask = (rng.random((8, size, size, 1)) > 0.6).astype(np.float32)
    test_img = rng.random((8, size, size, 1)).astype(np.float32)
    d = {"jax": jax_dice(seg_j, state_j.params["unet"],
                         state_j.stats["unet"], test_img, test_mask)}
    for name, (engine, seg) in runs.items():
        d[name] = jax_dice(seg_j, *state_dict_to_flax(
            seg.net, seg.net.state_dict()), test_img, test_mask)

    ours, base = losses["jax"], losses["base"]
    early = {k: float(np.max(np.abs(np.asarray(base[k][:20]) -
                                    np.asarray(ours[k][:20])) /
                             np.maximum(np.abs(np.asarray(ours[k][:20])),
                                        1e-6)))
             for k in PROBLEMS}
    rec = {
        "seed": seed, "n_steps": n_steps, "size": size,
        "argv": argv, "final_dice_jax": d["jax"],
        "final_dice_torch": d["base"],
        "gap_jax_vs_torch_pt": abs(d["jax"] - d["base"]) * 100,
        "early20_max_rel": early,
        "windowed_unet_rel_max": windowed_rel(base["unet"], ours["unet"]),
        "elapsed_sec": time.time() - t0,
    }
    for name, eps in controls:
        rec[f"final_dice_torch_{name}"] = d[name]
        rec[f"spread_torch_vs_torch_{name}_pt"] = abs(d["base"] -
                                                      d[name]) * 100
        rec[f"eps_{name}"] = eps
    return rec, losses


def one_step_deviation(seed: int, state_j, step_j, size: int) -> dict:
    """The port's relative deviation from the JAX engine after one paired
    iteration from seed ``seed``'s JAX state ``state_j`` (the ensemble's
    configuration at ``size``^2, ``step_j`` its jitted ``engine_step``),
    over seed ``seed``'s first batches and key: the losses' largest
    relative gap, and the
    parameters' (G, D, U-Net) relative norm gap, over all of them and the
    largest per tensor. Beside it, the elements whose update (after minus
    before) has another sign in the two frameworks, counted per tensor, and
    the relative norm gap of the other elements: what the gap is once the
    sign flips are set aside."""
    before = jax.device_get(state_j.params)
    engine, _ = port_engine(state_j, port_argv())
    batches = noise_batches(np.random.default_rng(11 + seed), 2, size)
    stack = {n: jax.tree.map(lambda x: jnp.asarray(x)[None], b)
             for n, b in batches.items()}
    key = jax.random.fold_in(jax.random.key(77 + seed), 0)
    state_j, mj = step_j(state_j, stack, stack["unet"], key)
    mt = engine.engine_step(
        [{n: {k: torch.from_numpy(v) for k, v in b.items()}
          for n, b in batches.items()}], None,
        {"replay": [{"unet": {"affine": affine_fn(size)(key)}}]})
    loss_rel = max(abs(float(mt[f"loss_{k}"]) - float(mj[f"loss_{k}"])) /
                   abs(float(mj[f"loss_{k}"])) for k in PROBLEMS)
    host = jax.device_get(state_j)
    num = den = num_kept = per_tensor = 0.0
    flips, n_all, n_tensors, n_flipped, leaves = 0, 0, 0, 0, []
    for p in engine.problems:
        want, _ = state_dict_to_flax(p.module, p.module.state_dict())
        paths = jax.tree_util.tree_flatten_with_path(host.params[p.name])[0]
        for a, (path, b), b0 in zip(jax.tree.leaves(want), paths,
                                    jax.tree.leaves(before[p.name])):
            a, b, b0 = (np.asarray(x, np.float64) for x in (a, b, b0))
            flip = np.sign(a - b0) != np.sign(b - b0)
            d2 = (a - b) ** 2
            diff, ref = float(d2.sum()), float((b ** 2).sum())
            kept = float(d2[~flip].sum())
            num, den, num_kept = num + diff, den + ref, num_kept + kept
            flips, n_all = flips + int(flip.sum()), n_all + flip.size
            n_tensors, n_flipped = n_tensors + 1, n_flipped + bool(flip.any())
            if ref > 0:
                per_tensor = max(per_tensor, (diff / ref) ** 0.5)
                leaves.append({
                    "leaf": p.name + "/" + "/".join(
                        str(getattr(k, "key", k)) for k in path),
                    "n": int(flip.size), "sign_flips": int(flip.sum()),
                    "rel": (diff / ref) ** 0.5,
                    "rel_unflipped": (kept / ref) ** 0.5})
    leaves.sort(key=lambda r: -r["rel"])
    return {"seed": seed, "loss_rel_max": loss_rel,
            "param_rel_norm": (num / den) ** 0.5,
            "param_rel_norm_max_tensor": per_tensor,
            "param_rel_norm_unflipped": (num_kept / den) ** 0.5,
            "param_rel_norm_unflipped_max_tensor": max(
                r["rel_unflipped"] for r in leaves),
            "sign_flips": flips, "elements": n_all,
            "tensors_with_flips": n_flipped,
            "tensors": n_tensors, "largest_tensors": leaves[:5]}


def summary(recs: list, n_steps: int, controls=CONTROLS) -> dict:
    """The ensemble's summary: per control (name, eps) its spreads, their
    mean and maximum, and Mann-Whitney p of the gap against them."""
    from scipy.stats import mannwhitneyu
    gaps = [r["gap_jax_vs_torch_pt"] for r in recs]
    out = {"summary": "drift_torch_ensemble", "n_steps": n_steps,
           "seeds": [r["seed"] for r in recs],
           **{f"eps_{name}": eps for name, eps in controls},
           "gap_jax_vs_torch_pt": gaps,
           "gap_mean_pt": float(np.mean(gaps)), "gap_max_pt": max(gaps)}
    for name, _ in controls:
        spread = [r[f"spread_torch_vs_torch_{name}_pt"] for r in recs]
        out.update({
            f"spread_torch_vs_torch_{name}_pt": spread,
            f"{name}_mean_pt": float(np.mean(spread)),
            f"{name}_max_pt": max(spread),
            f"mannwhitney_gap_vs_{name}_p": float(mannwhitneyu(
                gaps, spread, alternative="greater").pvalue)})
    out["early20_max_rel_all"] = max(max(r["early20_max_rel"].values())
                                     for r in recs)
    out["windowed_unet_rel_max_all"] = max(r["windowed_unet_rel_max"] or 0.0
                                           for r in recs)
    return out


def _seed_line(n_steps: int, seed: int, controls=CONTROLS) -> dict:
    cfg, engine_j, p2p_j, seg_j, step_j = jax_system()
    state_j = jax_state(cfg, engine_j, p2p_j, seg_j, seed)
    rec, _ = run_seed(seed, n_steps, engine_j, state_j, step_j, seg_j,
                      cfg.data.image_size, port_argv(), controls,
                      log=lambda s: print(s, file=sys.stderr, flush=True))
    return rec


def parse_controls(text: str):
    """``name=eps,name=eps`` -> ((name, eps), ...)."""
    return tuple((n, float(e)) for n, e in
                 (c.split("=") for c in text.split(",")))


def ensemble(n_steps: int, seeds: list, procs: int, out: str,
             controls=CONTROLS) -> dict:
    """Each seed in a child process (``seed`` mode), ``procs`` at a time;
    the per-seed lines and the summary written to ``out`` as they come."""
    recs, running, pending = {}, {}, list(seeds)

    def write():
        lines = [recs[s] for s in seeds if s in recs]
        if len(lines) == len(seeds):
            lines.append(summary(lines, n_steps, controls))
        with open(out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in lines)

    while pending or running:
        while pending and len(running) < procs:
            s = pending.pop(0)
            running[s] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "seed",
                 str(n_steps), str(s), "--controls",
                 ",".join(f"{n}={e!r}" for n, e in controls)],
                stdout=subprocess.PIPE, text=True)
        for s, p in list(running.items()):
            if p.poll() is not None:
                lines = [ln for ln in p.stdout.read().splitlines() if ln]
                if p.returncode != 0 or not lines:
                    raise RuntimeError(f"seed {s} failed (rc "
                                       f"{p.returncode})")
                recs[s] = json.loads(lines[-1])
                print(json.dumps(recs[s]), flush=True)
                del running[s]
                write()
        time.sleep(1.0)
    result = summary([recs[s] for s in seeds], n_steps, controls)
    print(json.dumps(result), flush=True)
    return result


def learning_side(side: str, size: int, iters: int, width: int,
                  save_dir: str, folder: str = "") -> dict:
    """One side of ``learning`` mode: the JAX package's or the port's
    ``train`` of the ``end2end_jsrt`` preset from its own fresh init on the
    synthetic 7/2/8 split (``scripts/validate_learning_tpu.py``'s and
    ``scripts/validate_torch_learning.py``'s settings) at ``size``^2
    (``unet_<size>``), ngf = ndf = U-Net base ``width``, float32, for
    ``iters`` iterations; from the JSRT folder ``folder`` if given."""
    if side == "port":
        from scripts.validate_torch_learning import validate
        data = ([f"--data.dataroot={folder}", "--data.synthetic=false"]
                if folder else [])
        rec = validate(iters, "cpu", [
            f"--data.image_size={size}", f"--model.netG=unet_{size}",
            f"--model.ngf={width}", f"--model.ndf={width}",
            f"--model.base_features={width}", "--model.compute_dtype=float32",
            "--run.name=port", *data], save_dir)
        return {"side": "port", "best_val": rec["best_val"],
                "test_dice": rec["test_dice"],
                "val_trajectory": rec["val_trajectory"]}
    from semantic_segmentation_tpu.core.config import \
        parse_config as parse_config_j
    from semantic_segmentation_tpu.train.train_end2end import train
    cfg = parse_config_j([], preset="end2end_jsrt")
    cfg.data.synthetic = not folder
    cfg.data.dataset, cfg.data.dataroot = "jsrt", folder
    cfg.data.image_size = size
    cfg.model.netG = f"unet_{size}"
    cfg.model.ngf = cfg.model.ndf = cfg.model.base_features = width
    cfg.model.compute_dtype = "float32"
    cfg.data.n_train, cfg.data.n_val, cfg.data.n_test = 7, 2, 8
    cfg.engine.valid_step = 25
    cfg.run.final_checkpoint = False
    cfg.run.save_dir, cfg.run.name = save_dir, "jax"
    _, results = train(cfg, train_iters=iters)
    with open(os.path.join(save_dir, "jax", "metrics.jsonl")) as f:
        vals = [[d["step"], d["val_score"]] for d in map(json.loads, f)
                if "val_score" in d]
    return {"side": "jax", "best_val": results["best_val"],
            "test_dice": results.get("test_dice"), "val_trajectory": vals}


def learning(size: int, iters: int, width: int, equalized: bool) -> int:
    """The two sides of ``learning`` mode at once, one process each; one
    JSON line a side. ``equalized``: both train from the synthetic split
    written as a JSRT folder (``validate_torch_learning.write_jsrt_folder``),
    whose loader equalizes the real images as the ``uint8_chain`` does the
    fakes."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        folder = []
        if equalized:
            from scripts.validate_torch_learning import write_jsrt_folder
            cfg = parse_config(["--data.n_train=7", "--data.n_val=2",
                                "--data.n_test=8",
                                f"--data.image_size={size}"],
                               preset="end2end_jsrt")
            folder = [write_jsrt_folder(cfg, os.path.join(d, "jsrt"))]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "learning-side",
             side, str(size), str(iters), str(width), d, *folder],
            stdout=subprocess.PIPE, text=True, cwd=ROOT)
            for side in ("jax", "port")]
        outs = [p.communicate()[0] for p in procs]
    for p, out in zip(procs, outs):
        print(out.strip().splitlines()[-1] if p.returncode == 0 and out
              else json.dumps({"rc": p.returncode}), flush=True)
    return max(p.returncode for p in procs)


def main(argv=None) -> int:
    # XLA's compile cache in the checkout (git-ignored): the seeds' processes
    # share the engine step's compile
    from semantic_segmentation_tpu.core.cache import enable_persistent_cache
    enable_persistent_cache(os.path.join(ROOT, ".jax_cache"))
    argv = sys.argv[1:] if argv is None else list(argv)
    opts = {}
    for flag in ("--procs", "--out", "--controls"):
        if flag in argv:
            i = argv.index(flag)
            opts[flag] = argv[i + 1]
            del argv[i:i + 2]
    mode = argv[0] if argv else "ensemble"
    if mode == "learning-side":
        size, iters, width = map(int, argv[2:5])
        print(json.dumps({"size": size, "iters": iters, "width": width,
                          "equalized": bool(argv[6:]),
                          **learning_side(argv[1], size, iters, width,
                                          *argv[5:])}), flush=True)
        return 0
    if mode == "learning":
        equalized = "--equalized" in argv
        rest = [int(a) for a in argv[1:] if a != "--equalized"]
        return learning(*(rest or [64, 400, 16]), equalized)
    rest = [int(a) for a in argv[1:]]
    controls = (parse_controls(opts["--controls"]) if "--controls" in opts
                else CONTROLS)
    if mode == "seed":
        print(json.dumps(_seed_line(rest[0], rest[1], controls)), flush=True)
    elif mode == "epsilon":
        cfg, engine_j, p2p_j, seg_j, step_j = jax_system()
        for s in rest or SEEDS:
            state_j = jax_state(cfg, engine_j, p2p_j, seg_j, s)
            print(json.dumps(one_step_deviation(
                s, state_j, step_j, cfg.data.image_size)), flush=True)
    elif mode == "flagship":
        cfg, engine_j, p2p_j, seg_j, step_j = jax_system(flagship=True)
        state_j = jax_state(cfg, engine_j, p2p_j, seg_j, 0)
        rec, losses = run_seed(
            0, rest[0] if rest else 30, engine_j, state_j, step_j, seg_j,
            cfg.data.image_size, port_argv(True), controls=(),
            log=lambda s: print(s, file=sys.stderr, flush=True))
        rec["losses"] = {n: losses[n] for n in ("jax", "base")}
        print(json.dumps(rec), flush=True)
    elif mode == "chain":
        cfg, engine_j, p2p_j, seg_j, step_j = jax_system(fakes="uint8_chain")
        seed = rest[1] if rest[1:] else 0
        state_j = jax_state(cfg, engine_j, p2p_j, seg_j, seed)
        rec, _ = run_seed(
            seed, rest[0] if rest else 1000, engine_j, state_j, step_j,
            seg_j, cfg.data.image_size, port_argv(fakes="uint8_chain"),
            controls=(("ulp", ULP),),
            log=lambda s: print(s, file=sys.stderr, flush=True))
        print(json.dumps({"fakes": "uint8_chain", **rec}), flush=True)
    elif mode == "ensemble":
        n_steps = rest[0] if rest else 1000
        seeds = rest[1:] or SEEDS
        ensemble(n_steps, seeds, int(opts.get("--procs", len(seeds))),
                 opts.get("--out",
                          os.path.join(ROOT, "DRIFT_ENSEMBLE_torch.json")),
                 controls)
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
