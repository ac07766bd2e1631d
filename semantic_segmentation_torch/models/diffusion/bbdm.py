"""Brownian Bridge Diffusion (BBDM) — the port of
``semantic_segmentation_tpu/models/diffusion/bbdm.py``
(``BBDM/model/BrownianBridge/BrownianBridgeModel.py``).

The bridge schedule (:42-79), the training loss ``p_losses`` (:98-126) with
objective in {grad, noise, ysubx}, ``q_sample`` (:128-146) and the
ancestral sampler ``p_sample(_loop)`` (:171-221) with 200-step linear
skip sampling. The schedule tables are built with numpy exactly as the JAX
package builds them (a float step in ``torch.arange`` can give another
length) and held as float32 tensors; the step table stays on the host, so
the sampler's final-step branch costs no device sync.

Every draw can be injected: ``p_losses`` takes ``draws={'t', 'noise'}``
and ``p_sample_loop`` a list of per-step noises (the JAX package's
``normal(fold_in(rng, i))``), and each draws what it is not given from a
``torch.Generator``. The denoiser is a callable ``denoise(x_t, t, context,
train) -> objective_recon``; tensors are in the denoiser's layout (NCHW
for ``ADMUNet``), the tables broadcast over every axis but the batch.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from semantic_segmentation_torch.parallel import collectives


@dataclass(frozen=True)
class BridgeSchedule:
    """register_schedule (:42-79): every table precomputed on the host."""
    num_timesteps: int = 1000
    mt_type: str = "linear"          # linear | sin
    max_var: float = 1.0
    eta: float = 1.0
    skip_sample: bool = True
    sample_type: str = "linear"      # linear | cosine
    sample_step: int = 200
    m_t: np.ndarray = field(init=False, repr=False)
    variance_t: np.ndarray = field(init=False, repr=False)
    steps: np.ndarray = field(init=False, repr=False)

    def __post_init__(self):
        T = self.num_timesteps
        if self.mt_type == "linear":
            m_t = np.linspace(0.001, 0.999, T)
        elif self.mt_type == "sin":
            m_t = 1.0075 ** np.linspace(0, T, T)
            m_t = m_t / m_t[-1]
            m_t[-1] = 0.999
        else:
            raise NotImplementedError(self.mt_type)
        variance_t = 2.0 * (m_t - m_t ** 2) * self.max_var
        if self.skip_sample:
            if self.sample_type == "linear":
                midsteps = np.arange(
                    T - 1, 1,
                    -((T - 1) / (self.sample_step - 2))).astype(np.int64)
                steps = np.concatenate([midsteps, [1, 0]])
            elif self.sample_type == "cosine":
                s = np.linspace(0, T, self.sample_step + 1)
                steps = ((np.cos(s / T * np.pi) + 1.0) / 2.0
                         * T).astype(np.int64)
            else:
                raise NotImplementedError(self.sample_type)
        else:
            steps = np.arange(T - 1, -1, -1)
        object.__setattr__(self, "m_t", m_t.astype(np.float32))
        object.__setattr__(self, "variance_t", variance_t.astype(np.float32))
        object.__setattr__(self, "steps", steps.astype(np.int32))


def _bcast(table, t, ndim: int):
    return table[t].reshape((-1,) + (1,) * (ndim - 1))


class BrownianBridge:
    """The bridge process around a denoiser (see the module docstring).
    ``condition_key`` 'nocond' drops the context; otherwise the context is
    ``y`` unless one is given."""

    def __init__(self, schedule: BridgeSchedule, objective: str = "grad",
                 loss_type: str = "l1",
                 condition_key: str = "SpatialRescaler"):
        self.sched = schedule
        self.objective = objective
        self.loss_type = loss_type
        self.condition_key = condition_key
        self._tables: dict = {}

    def tables(self, device):
        """(m_t, variance_t) as float32 tensors on ``device``."""
        key = str(device)
        if key not in self._tables:
            self._tables[key] = tuple(
                torch.from_numpy(a).to(device)
                for a in (self.sched.m_t, self.sched.variance_t))
        return self._tables[key]

    def _context(self, y, context):
        if self.condition_key == "nocond":
            return None
        return y if context is None else context

    # -- forward process ----------------------------------------------------
    def q_sample(self, x0, y, t, noise):
        m, var = self.tables(x0.device)
        m_t = _bcast(m, t, x0.dim())
        sigma_t = torch.sqrt(_bcast(var, t, x0.dim()))
        if self.objective == "grad":
            objective = m_t * (y - x0) + sigma_t * noise
        elif self.objective == "noise":
            objective = noise
        elif self.objective == "ysubx":
            objective = y - x0
        else:
            raise NotImplementedError(self.objective)
        x_t = (1.0 - m_t) * x0 + m_t * y + sigma_t * noise
        return x_t, objective

    def predict_x0_from_objective(self, x_t, y, t, objective_recon):
        if self.objective == "grad":
            return x_t - objective_recon
        if self.objective == "noise":
            m, var = self.tables(x_t.device)
            m_t = _bcast(m, t, x_t.dim())
            var_t = _bcast(var, t, x_t.dim())
            return (x_t - m_t * y - torch.sqrt(var_t) * objective_recon) \
                / (1.0 - m_t)
        if self.objective == "ysubx":
            return y - objective_recon
        raise NotImplementedError(self.objective)

    # -- training loss (p_losses, :98-126) ---------------------------------
    def draw_losses(self, x0, generator: torch.Generator | None = None):
        """The draws of one ``p_losses`` call: 't' (B,) int64 uniform over
        the timesteps and 'noise', standard normal of ``x0``'s shape (of
        the global batch's size under data parallelism)."""
        b = collectives.global_batch(x0.shape[0])
        t = torch.randint(0, self.sched.num_timesteps, (b,),
                          generator=generator, device=x0.device)
        noise = torch.randn((b,) + tuple(x0.shape[1:]), generator=generator,
                            device=x0.device, dtype=x0.dtype)
        return {"t": t, "noise": noise}

    def p_losses(self, denoise, x0, y, draws=None,
                 generator: torch.Generator | None = None, context=None,
                 train: bool = True):
        """(reconstruction loss, {'x0_recon'}): the l1 or l2 mean between
        the objective and the denoiser's estimate at ``q_sample(x0, y, t,
        noise)``; ``draws`` as ``draw_losses`` gives them, else drawn from
        ``generator`` (the global batch's: this rank takes its rows)."""
        context = self._context(y, context)
        draws = draws or self.draw_losses(x0, generator)
        b = x0.shape[0]
        t = collectives.rows(draws["t"], b)
        noise = collectives.rows(draws["noise"], b)
        x_t, objective = self.q_sample(x0, y, t, noise)
        objective_recon = denoise(x_t, t, context, train)
        diff = objective - objective_recon
        if self.loss_type == "l1":
            recloss = diff.abs().mean()
        elif self.loss_type == "l2":
            recloss = diff.square().mean()
        else:
            raise NotImplementedError(self.loss_type)
        x0_recon = self.predict_x0_from_objective(x_t, y, t, objective_recon)
        return recloss, {"x0_recon": x0_recon}

    # -- ancestral sampling (p_sample/p_sample_loop, :171-221) -------------
    @torch.no_grad()
    def p_sample_step(self, denoise, x_t, y, context, i: int, noise=None,
                      generator: torch.Generator | None = None,
                      clip_denoised: bool = True):
        """Step ``i`` of the step table: (x at the next step, x0_recon). At
        step 0 the next x is ``x0_recon`` and nothing is drawn; elsewhere
        the noise is ``noise`` or drawn from ``generator``."""
        b, nd = x_t.shape[0], x_t.dim()
        steps = self.sched.steps
        step = int(steps[i])
        dev = x_t.device
        t = torch.full((b,), step, dtype=torch.int64, device=dev)
        objective_recon = denoise(x_t, t, context, False)
        x0_recon = self.predict_x0_from_objective(x_t, y, t, objective_recon)
        if clip_denoised:
            x0_recon = torch.clamp(x0_recon, -1.0, 1.0)
        if step == 0:
            return x0_recon, x0_recon
        n_t = torch.full((b,), int(steps[min(i + 1, len(steps) - 1)]),
                         dtype=torch.int64, device=dev)
        m, var = self.tables(dev)
        m_t, m_nt = _bcast(m, t, nd), _bcast(m, n_t, nd)
        var_t, var_nt = _bcast(var, t, nd), _bcast(var, n_t, nd)
        sigma2_t = (var_t - var_nt * (1.0 - m_t) ** 2 /
                    (1.0 - m_nt) ** 2) * var_nt / var_t
        sigma_t = torch.sqrt(torch.clamp(sigma2_t, min=0.0)) * self.sched.eta
        if noise is None:
            noise = torch.randn(x_t.shape, generator=generator, device=dev,
                                dtype=x_t.dtype)
        mean = (1.0 - m_nt) * x0_recon + m_nt * y + \
            torch.sqrt(torch.clamp((var_nt - sigma2_t) / var_t, min=0.0)) * \
            (x_t - (1.0 - m_t) * x0_recon - m_t * y)
        return mean + sigma_t * noise, x0_recon

    @torch.no_grad()
    def p_sample_loop(self, denoise, y, noises=None,
                      generator: torch.Generator | None = None, context=None,
                      clip_denoised: bool = True):
        """The whole step table from ``x = y``; ``noises[i]`` (where given)
        is step ``i``'s noise."""
        context = self._context(y, context)
        img = y
        for i in range(len(self.sched.steps)):
            img, _ = self.p_sample_step(
                denoise, img, y, context, i,
                None if noises is None else noises[i], generator,
                clip_denoised)
        return img
