"""The bilevel engine that replaces Betty — the port of
``semantic_segmentation_tpu/engine/bilevel.py``.

The reference wires Generator, Discriminator and Unet (inner) and Arch
(outer) problems into ``betty.engine.Engine`` with ``Config(type='darts',
unroll_steps)`` and ``roll_back=True`` (``train_end2end_jsrt.py:289-342``).
One engine iteration:

  1. each inner problem takes one optimizer step per unroll step, in order
     netG -> netD -> unet, each on its own batch (``bilevel.py:115-133``);
  2. the arch variables take an Adam step on their hypergradient;
  3. with ``roll_back`` the inner problems restart from their pre-unroll
     state (parameters, BN buffers, optimizer state, and the draws'
     generator) and replay the K steps under the new arch.

The four modes (``bilevel.py:242-317``):

- ``darts`` (``:157-199``): Betty's finite difference. For each arch child,
  ``v = dL_val/dw_child`` at the unrolled state, ``eps = darts_epsilon /
  ||v||``, and ``hg = dL_val/da - lr * (g+ - g-) / (2 eps)`` with ``g±``
  the arch gradient of the child's train loss at ``w ± eps v`` on the last
  unroll batch. Under the reference wiring (outer loss on the unet only,
  child netG) ``v = 0`` and ``hg`` is exactly 0.
- ``unroll`` (``:201-240``): the exact gradient of the validation loss
  through K SGD-surrogate inner steps ``w' = w - lr dL/dw`` from the
  pre-unroll state, taken with ``create_graph``. The surrogate is SGD because
  the real adaptive optimizers are not differentiable at zero second
  moments; the real trajectory keeps the real optimizers.
- ``decay_only``: the reference wiring's zero hypergradient without
  computing it: Adam on a zero gradient (weight decay alone). With
  ``roll_back`` the pre-arch unroll is discarded by the rollback, so it is
  skipped and the K steps run once, under the new arch, with the replay's
  draws (``:252-279``). Same trajectory as ``darts`` under that wiring.
- ``none``: the K inner steps, the arch untouched.

State is PyTorch's own: each problem's module holds its parameters and BN
running stats (buffers, updated in place by every train-mode forward), each
problem has its optimizer, and the arch tables are plain tensors with their
Adam. The hypergradients run the nets on other weights through
``functional_call`` on scratch buffers, so they never write real state.

Random draws (augment affines, dropout masks) come from ``generator``; the
hypergradients draw from ``hyper_generator``, so they do not advance the
main stream, and a rollback restores ``generator``'s state, so the replay
draws what ``decay_only``'s single unroll draws. The two finite-difference
evaluations share their draws and run with cuDNN's deterministic
algorithms, so that ``g+ - g-`` is exactly 0 when the shift is.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Sequence

import torch

MODES = ("darts", "unroll", "decay_only", "none")


@dataclass
class InnerProblem:
    """One inner level.

    ``loss(batch, draws, params=None, generator=None) -> scalar`` runs
    whatever nets it needs in train mode. ``draws`` holds random draws to use
    instead of ``generator``'s (tests inject the JAX package's draws through
    it); it may be empty. ``params`` maps a problem name, or ``'arch'``, to a
    dict of tensors that net runs on instead of its module's own parameters
    (or the arch tables); when it is given, every net runs on scratch BN
    buffers. ``module`` holds the parameters ``optimizer`` steps; ``lr`` is
    the construction-time inner learning rate the hypergradients use."""
    name: str
    loss: Callable[..., torch.Tensor]
    module: torch.nn.Module
    optimizer: torch.optim.Optimizer
    lr: float = 0.0

    @property
    def params(self) -> list:
        return list(self.module.parameters())


def _grads(out, wrt: list) -> list:
    """d out / d wrt, zeros for the tensors ``out`` does not depend on."""
    grads = (torch.autograd.grad(out, wrt, allow_unused=True)
             if out.requires_grad else [None] * len(wrt))
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(grads, wrt)]


def _global_norm(tensors):
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


class _DeterministicCudnn:
    """cuDNN's deterministic algorithms for the duration of a block."""

    def __enter__(self):
        self.saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True

    def __exit__(self, *exc):
        torch.backends.cudnn.deterministic = self.saved


class BilevelEngine:
    """``outer_loss(params, val_batch) -> scalar``: the arch problem's
    validation loss, ``params`` as in ``InnerProblem.loss`` (None: the
    modules' own parameters); it must run on scratch BN buffers whatever
    ``params`` is. Needed by ``darts`` and ``unroll``."""

    def __init__(self, problems: Sequence[InnerProblem], arch: dict,
                 arch_optimizer: torch.optim.Optimizer | None,
                 outer_loss: Callable | None = None,
                 unroll_steps: int = 1, roll_back: bool = True,
                 hypergrad: str = "darts", darts_epsilon: float = 0.01,
                 arch_children: Sequence[str] = ("netG",),
                 generator: torch.Generator | None = None,
                 hyper_generator: torch.Generator | None = None):
        if hypergrad not in MODES:
            raise ValueError(f"unknown hypergrad {hypergrad!r}; one of "
                             f"{MODES}")
        if hypergrad in ("darts", "unroll") and outer_loss is None:
            raise ValueError(f"hypergrad={hypergrad!r} needs an outer_loss")
        self.problems = tuple(problems)
        names = [p.name for p in self.problems]
        unknown = set(arch_children) - set(names)
        if hypergrad == "darts" and unknown:
            raise ValueError(f"arch_children {sorted(unknown)} are not "
                             f"problems ({names})")
        self.arch = arch
        self.arch_optimizer = arch_optimizer
        self.outer_loss = outer_loss
        self.unroll_steps = unroll_steps
        self.roll_back = roll_back
        self.hypergrad = hypergrad
        self.darts_epsilon = darts_epsilon
        self.arch_children = tuple(arch_children)
        self.generator = generator
        self.hyper_generator = hyper_generator
        self.step = 0

    # -- the real trajectory ----------------------------------------------
    def inner_step(self, batches: dict, draws: dict):
        """One optimizer step of every inner problem, in order."""
        metrics = {}
        for p in self.problems:
            loss = p.loss(batches[p.name], draws.get(p.name, {}), None,
                          self.generator)
            p.optimizer.zero_grad(set_to_none=True)
            loss.backward(inputs=p.params)
            p.optimizer.step()
            metrics[f"loss_{p.name}"] = loss.detach()
        return metrics

    def _unroll(self, batch_stack, draws_stack):
        metrics = {}
        for k in range(self.unroll_steps):
            metrics = self.inner_step(batch_stack[k],
                                      draws_stack[k] if draws_stack else {})
        return metrics

    def _snapshot(self):
        """Every problem's parameters and BN buffers, its optimizer state,
        and the draws' generator state."""
        return ([({k: v.detach().clone()
                   for k, v in p.module.state_dict().items()},
                  copy.deepcopy(p.optimizer.state_dict()))
                 for p in self.problems],
                None if self.generator is None
                else self.generator.get_state())

    def _restore(self, snapshot):
        """Back to ``snapshot``, in place: the optimizers keep their
        ``Parameter`` objects."""
        states, gen_state = snapshot
        for p, (module_state, opt_state) in zip(self.problems, states):
            p.module.load_state_dict(module_state)
            p.optimizer.load_state_dict(opt_state)
        if gen_state is not None:
            self.generator.set_state(gen_state)

    # -- checkpoint ---------------------------------------------------------
    def state_dict(self) -> dict:
        """Everything the next iteration reads, for a checkpoint: the
        iteration count, each problem's parameters and BN buffers and its
        optimizer's state, the arch tables and their optimizer's state, and
        both generators' states. The JAX engine draws from
        ``fold_in(root, it)``, which needs no state; these generators do.
        Tensors are references, as a module's ``state_dict`` gives them."""
        return {
            "step": self.step,
            "problems": {p.name: {"module": p.module.state_dict(),
                                  "optimizer": p.optimizer.state_dict()}
                         for p in self.problems},
            "arch": {k: a.detach() for k, a in self.arch.items()},
            "arch_optimizer": (None if self.arch_optimizer is None
                               else self.arch_optimizer.state_dict()),
            "generator": (None if self.generator is None
                          else self.generator.get_state()),
            "hyper_generator": (None if self.hyper_generator is None
                                else self.hyper_generator.get_state()),
        }

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        """Back to ``state`` (a ``state_dict()``), in place: the optimizers
        keep their ``Parameter`` objects, the arch tables their tensors."""
        for p in self.problems:
            p.module.load_state_dict(state["problems"][p.name]["module"])
            p.optimizer.load_state_dict(state["problems"][p.name]["optimizer"])
        if state["arch"].keys() != self.arch.keys():
            raise ValueError(f"arch tables {sorted(state['arch'])}, expected "
                             f"{sorted(self.arch)}")
        for k, a in self.arch.items():
            a.copy_(state["arch"][k])
        if self.arch_optimizer is not None:
            self.arch_optimizer.load_state_dict(state["arch_optimizer"])
        for name in ("generator", "hyper_generator"):
            gen = getattr(self, name)
            if gen is not None:
                gen.set_state(state[name])
        self.step = int(state["step"])

    @torch.no_grad()
    def _arch_step(self, hg: dict):
        """Adam on the hypergradient ``hg`` (arch name -> tensor)."""
        for k, a in self.arch.items():
            a.grad = hg[k]
        self.arch_optimizer.step()

    def _arch_decay_step(self):
        """Adam on a zero hypergradient: the arch moves by weight decay."""
        self._arch_step({k: torch.zeros_like(a)
                         for k, a in self.arch.items()})

    # -- hypergradients -----------------------------------------------------
    def _arch_leaves(self):
        return {k: a.detach().requires_grad_(True)
                for k, a in self.arch.items()}

    def _darts_hypergrad(self, batch_stack, val_batch, draws):
        """Betty darts at the unrolled (current) state. Returns (hg, outer
        loss)."""
        arch = self._arch_leaves()
        children = [p for p in self.problems if p.name in self.arch_children]
        weights = {p.name: dict(p.module.named_parameters())
                   for p in children}
        child_ws = [w for p in children for w in weights[p.name].values()]
        outer = self.outer_loss({"arch": arch}, val_batch)
        grads = _grads(outer, list(arch.values()) + child_ws)
        hg = dict(zip(arch, grads[:len(arch)]))
        v_all = iter(grads[len(arch):])
        last_batch = batch_stack[-1]
        last_draws = draws[-1] if draws else {}
        for p in children:
            v = {n: next(v_all) for n in weights[p.name]}
            eps = self.darts_epsilon / (_global_norm(v.values()) + 1e-12)
            gen_state = (None if self.hyper_generator is None
                         else self.hyper_generator.get_state())

            def train_arch_grad(sign: float):
                # the same draws for both signs
                if gen_state is not None:
                    self.hyper_generator.set_state(gen_state)
                shifted = {n: w.detach() + sign * eps * v[n]
                           for n, w in weights[p.name].items()}
                a = self._arch_leaves()
                loss = p.loss(last_batch[p.name], last_draws.get(p.name, {}),
                              {p.name: shifted, "arch": a},
                              self.hyper_generator)
                return dict(zip(a, _grads(loss, list(a.values()))))

            with _DeterministicCudnn():
                g_plus = train_arch_grad(+1.0)
                g_minus = train_arch_grad(-1.0)
            hg = {k: hg[k] - p.lr * (g_plus[k] - g_minus[k]) / (2.0 * eps)
                  for k in hg}
        return hg, outer.detach()

    def _unroll_hypergrad(self, batch_stack, val_batch, draws):
        """The gradient of the validation loss through K SGD-surrogate inner
        steps from the current state (taken before the real unroll, so the
        current state is the pre-unroll one)."""
        arch = self._arch_leaves()
        cur = {p.name: {n: w.detach().requires_grad_(True)
                        for n, w in p.module.named_parameters()}
               for p in self.problems}
        for k in range(self.unroll_steps):
            draws_k = draws[k] if draws else {}
            for p in self.problems:
                loss = p.loss(batch_stack[k][p.name], draws_k.get(p.name, {}),
                              {**cur, "arch": arch}, self.hyper_generator)
                names = list(cur[p.name])
                ws = [cur[p.name][n] for n in names]
                grads = torch.autograd.grad(loss, ws, create_graph=True,
                                            allow_unused=True)
                cur[p.name] = {n: w if g is None else w - p.lr * g
                               for n, w, g in zip(names, ws, grads)}
        outer = self.outer_loss({**cur, "arch": arch}, val_batch)
        return dict(zip(arch, _grads(outer, list(arch.values()))))

    # -- one iteration --------------------------------------------------------
    def engine_step(self, batch_stack, val_batch=None, draws=None):
        """One engine iteration. ``batch_stack``: K dicts, problem name ->
        that problem's batch; ``val_batch``: the outer loss's batch (read by
        ``darts`` and ``unroll``). ``draws`` (optional) injects random draws
        per phase, the JAX engine's keys ``rng_u``, ``rng_h``, ``rng_r``:
        {'unroll' | 'hyper' | 'replay': K dicts, problem name -> draws};
        ``darts`` reads the last 'hyper' dict. Returns the JAX engine's
        metrics: ``loss_*``, ``outer_loss`` (darts, unroll),
        ``arch_grad_norm`` (every mode that steps the arch) and, with
        ``roll_back``, ``replay_loss_*``."""
        draws = draws or {}
        d_unroll, d_hyper, d_replay = (draws.get(k) for k in
                                       ("unroll", "hyper", "replay"))
        self.step += 1
        if self.hypergrad == "none":
            return self._unroll(batch_stack, d_unroll)
        if self.hypergrad == "decay_only":
            if self.roll_back:
                self._arch_decay_step()
                metrics = self._unroll(batch_stack, d_replay)
                metrics.update({f"replay_{k}": v
                                for k, v in list(metrics.items())})
            else:
                metrics = self._unroll(batch_stack, d_unroll)
                self._arch_decay_step()
            metrics["arch_grad_norm"] = next(iter(
                self.arch.values())).new_zeros(())
            return metrics

        snapshot = self._snapshot() if self.roll_back else None
        if self.hypergrad == "unroll":
            hg = self._unroll_hypergrad(batch_stack, val_batch, d_hyper)
        metrics = self._unroll(batch_stack, d_unroll)
        if self.hypergrad == "darts":
            hg, metrics["outer_loss"] = self._darts_hypergrad(
                batch_stack, val_batch, d_hyper)
        else:
            with torch.no_grad():
                metrics["outer_loss"] = self.outer_loss(None, val_batch)
        self._arch_step(hg)
        metrics["arch_grad_norm"] = _global_norm(hg.values()).detach()
        if self.roll_back:
            self._restore(snapshot)
            replay = self._unroll(batch_stack, d_replay)
            metrics.update({f"replay_{k}": v for k, v in replay.items()})
        return metrics
