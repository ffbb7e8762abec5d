"""SR3 Gaussian diffusion: the ancestral reverse loop and DDIM
(rsvldm_tpu/models/sr3/diffusion.py: SR3Diffusion.from_schedule,
sr3_sample, sr3_sample_ddim).

The JAX package runs each loop as one lax.scan with the schedule gathered
by a traced index. Here each is one step function on device tensors:
the latent, a step counter, the schedule scalars as [steps] tables read at
that counter, and the noise, an argument laid out as the JAX
`noise_override`: [0] is x_T, [1+i] the noise of loop step i (multiplied
by a tabled 0 where JAX zeroes it). The step is driven by
utils/graphs.StepRunner: called directly on the CPU, captured once and
replayed on the card. Tables are float32, as JAX's. A caller's
`graph_cache` keeps a loop's tensors and graph per input shape and sampler
across calls (the counterpart of the JAX pipeline's per-shape jit cache).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...diffusion.schedules import DDPMBuffers, ddpm_buffers, make_beta_schedule
from ...utils.graphs import StepRunner, use_graphs


@dataclasses.dataclass(frozen=True)
class SR3Diffusion:
    """Schedule tables of the sampler; x_0 predictions are clipped to
    [-1, 1], as the reference's default."""
    buffers: DDPMBuffers

    @classmethod
    def from_schedule(cls, schedule: str = "linear", n_timestep: int = 500,
                      linear_start: float = 1e-6, linear_end: float = 1e-2
                      ) -> "SR3Diffusion":
        betas = make_beta_schedule(schedule, n_timestep, linear_start, linear_end)
        return cls(buffers=ddpm_buffers(betas))


def ddim_timesteps(num_timesteps: int, num_steps: int) -> np.ndarray:
    """DDIM's descending timestep subset (JAX sr3_sample_ddim): num_steps
    (at most T) rounded points of linspace(T-1, 0), repeats removed."""
    num_steps = min(num_steps, num_timesteps)
    ts = np.unique(np.round(np.linspace(num_timesteps - 1, 0, num_steps)))
    return ts[::-1].astype(np.int64)


def _check_noise(noise, rows, cond):
    if noise.shape[0] != rows or noise.shape[1:] != cond.shape:
        raise ValueError(f"noise {tuple(noise.shape)} is not [{rows}, "
                         f"*cond.shape] = [{rows}, {tuple(cond.shape)}]")


def _tables(cols, device):
    """{name: fp32 [steps] tensor on device}."""
    return {k: v.to(device, torch.float32) for k, v in cols.items()}


class LoopTensors:
    """What a Stage-1 loop owns on cond's device, in fp32: the
    conditioning `c` and the noise as NCHW views of NHWC buffers, the
    latent `x` (a copy of noise[0]) and the 0-d step counter `i`. `load`
    copies a new call's inputs in and resets the counter, so a step
    captured over these tensors replays on them."""

    def __init__(self, cond: torch.Tensor, noise: torch.Tensor):
        dev = cond.device
        self.c = torch.empty(cond.shape, dtype=torch.float32,
                             device=dev).permute(0, 3, 1, 2)
        self.noise = torch.empty(noise.shape, dtype=torch.float32,
                                 device=dev).permute(0, 1, 4, 2, 3)
        self.x = self.noise[0].clone()
        self.i = torch.zeros((), dtype=torch.long, device=dev)
        self.load(cond, noise)

    def load(self, cond: torch.Tensor, noise: torch.Tensor):
        self.c.copy_(cond.permute(0, 3, 1, 2))
        self.noise.copy_(noise.permute(0, 1, 4, 2, 3))
        self.x.copy_(self.noise[0])
        self.i.zero_()


def _ancestral(diff: SR3Diffusion, model, lt: LoopTensors):
    """The ancestral loop's step over `lt`, one step t = T-1-i a call."""
    buf = diff.buffers
    T = buf.num_timesteps
    ts = torch.arange(T - 1, -1, -1)  # loop step i runs t = T-1-i
    tab = _tables({
        "level": buf.sqrt_alphas_cumprod_prev[ts + 1],
        "recip": buf.sqrt_recip_alphas_cumprod[ts],
        "recipm1": buf.sqrt_recipm1_alphas_cumprod[ts],
        "coef1": buf.posterior_mean_coef1[ts],
        "coef2": buf.posterior_mean_coef2[ts],
        # JAX's where(t > 0, noise, 0) as a multiply by a tabled 0 / 1
        "std": (torch.exp(0.5 * buf.posterior_log_variance_clipped[ts])
                * (ts > 0).float()),
    }, lt.x.device)
    c, noise, x, i = lt.c, lt.noise, lt.x, lt.i
    n = x.shape[0]

    def step():
        at = lambda k: tab[k].index_select(0, i)
        eps = model(torch.cat([c, x], dim=1), at("level").expand(n, 1))
        x_recon = (at("recip") * x - at("recipm1") * eps).clamp(-1.0, 1.0)
        mean = at("coef1") * x_recon + at("coef2") * x
        x.copy_(mean + noise.index_select(0, i + 1)[0] * at("std"))
        i.add_(1)
    return step


def ancestral_step(diff: SR3Diffusion, model, cond: torch.Tensor,
                   noise: torch.Tensor):
    """(step, x): the ancestral loop's step function and the NCHW fp32
    latent it advances in place, one step t = T-1-i a call (shapes as in
    `sr3_sample`)."""
    _check_noise(noise, diff.buffers.num_timesteps + 1, cond)
    lt = LoopTensors(cond, noise)
    return _ancestral(diff, model, lt), lt.x


def _ddim(diff: SR3Diffusion, model, lt: LoopTensors, num_steps: int,
          eta: float):
    """DDIM's step over `lt`."""
    buf = diff.buffers
    ts = torch.from_numpy(ddim_timesteps(buf.num_timesteps, num_steps))
    # the per-step scalars in float32, as JAX's traced arithmetic
    abar = 1.0 / buf.sqrt_recip_alphas_cumprod ** 2
    a_t = abar[ts]
    prev = torch.cat([ts[1:], torch.tensor([-1])])
    a_prev = torch.cat([abar, torch.ones(1)])[prev]
    one_minus = torch.clamp(1.0 - a_t, min=1e-20)
    sigma = eta * torch.sqrt(torch.clamp(
        (1.0 - a_prev) / one_minus * (1.0 - a_t / a_prev), min=0.0))
    tab = _tables({
        "level": buf.sqrt_alphas_cumprod_prev[ts + 1],
        "recip": buf.sqrt_recip_alphas_cumprod[ts],
        "recipm1": buf.sqrt_recipm1_alphas_cumprod[ts],
        "sqrt_a": torch.sqrt(a_t),
        "eps_den": torch.sqrt(one_minus),
        "sqrt_a_prev": torch.sqrt(a_prev),
        "dir": torch.sqrt(torch.clamp(1.0 - a_prev - sigma ** 2, min=0.0)),
        # JAX's where(t_prev >= 0, noise, 0) as a multiply by a tabled 0
        "sigma": sigma * (prev >= 0).float(),
    }, lt.x.device)
    c, noise, x, j = lt.c, lt.noise, lt.x, lt.i
    n = x.shape[0]

    def step():
        at = lambda k: tab[k].index_select(0, j)
        eps = model(torch.cat([c, x], dim=1), at("level").expand(n, 1))
        x_recon = (at("recip") * x - at("recipm1") * eps).clamp(-1.0, 1.0)
        eps_eff = (x - at("sqrt_a") * x_recon) / at("eps_den")
        x.copy_(at("sqrt_a_prev") * x_recon + at("dir") * eps_eff
                + at("sigma") * noise.index_select(0, j + 1)[0])
        j.add_(1)
    return step


def _run(key, make_step, steps: int, diff, model, cond, noise, graphs,
         stats, graph_cache) -> torch.Tensor:
    """`steps` calls of a loop's step through one StepRunner. The loop's
    tensors and runner are kept in `graph_cache` (a dict the caller keeps)
    under (key, cond's shape, diff, model, graphs): a later call with the
    same key loads its inputs into them and replays the kept graph,
    capturing nothing. stats["capture_s"]: this call's capture seconds.
    Returns x_0 [N, H, W, 3] fp32, a tensor of its own."""
    on = use_graphs(cond.device, graphs)
    key = (*key, tuple(cond.shape), id(diff), id(model), on)
    loop = (graph_cache or {}).get(key)
    if loop is None:
        lt = LoopTensors(cond, noise)
        loop = (lt, StepRunner(make_step(lt), on))
        if graph_cache is not None:
            graph_cache[key] = loop
    else:
        loop[0].load(cond, noise)
    lt, runner = loop
    captured = runner.capture_s
    for _ in range(steps):
        runner()
    if stats is not None:
        stats["capture_s"] = runner.capture_s - captured
    return lt.x.permute(0, 2, 3, 1).clone()


@torch.no_grad()
def sr3_sample(diff: SR3Diffusion, model, cond: torch.Tensor,
               noise: torch.Tensor, graphs: bool | None = None,
               stats: dict | None = None,
               graph_cache: dict | None = None) -> torch.Tensor:
    """Reverse diffusion from t = T-1 to 0 conditioned on `cond`.

    cond: [N, H, W, 3] in [-1, 1]; noise: [T+1, N, H, W, 3] unit normals;
    model(x [N, 6, H, W], noise_level [N, 1]) -> eps [N, 3, H, W].
    graphs: replay the step as a CUDA graph (default: on CUDA). stats, when
    given, receives capture_s; graph_cache keeps the loop across calls
    (`_run`). Returns x_0 [N, H, W, 3] fp32."""
    T = diff.buffers.num_timesteps
    _check_noise(noise, T + 1, cond)
    return _run(("ddpm",), lambda lt: _ancestral(diff, model, lt), T, diff,
                model, cond, noise, graphs, stats, graph_cache)


@torch.no_grad()
def sr3_sample_ddim(diff: SR3Diffusion, model, cond: torch.Tensor,
                    noise: torch.Tensor, num_steps: int = 50,
                    eta: float = 0.0, graphs: bool | None = None,
                    stats: dict | None = None,
                    graph_cache: dict | None = None) -> torch.Tensor:
    """DDIM (Song et al., arXiv:2010.02502) on the SR3 schedule, over the
    timesteps of `ddim_timesteps(T, num_steps)` (JAX :101-156): the
    conditioning of the ancestral loop, x_0 clipped, eps recomputed from
    the clipped x_0, the step to t_prev (abar 1 past the last) with
    sigma = eta * sqrt((1 - a_prev) / (1 - a_t) * (1 - a_t / a_prev)).

    noise: [len(ts)+1, N, H, W, 3] unit normals, [0] = x_T, [1+j] the noise
    of step j (unused where t_prev < 0). graphs, stats and graph_cache as
    in `sr3_sample`. Returns x_0 [N, H, W, 3] fp32."""
    steps = len(ddim_timesteps(diff.buffers.num_timesteps, num_steps))
    _check_noise(noise, steps + 1, cond)
    return _run(("ddim", num_steps, eta),
                lambda lt: _ddim(diff, model, lt, num_steps, eta), steps,
                diff, model, cond, noise, graphs, stats, graph_cache)


def sr3_draws(diff: SR3Diffusion, shape: tuple, generator, device):
    """sr3_loss's draws for a batch of `shape` [N, H, W, 3], in its order:
    t [N] in 1..T, u [N] uniform, noise normal of `shape`."""
    b = shape[0]
    t = torch.randint(1, diff.buffers.num_timesteps + 1, (b,),
                      generator=generator, device=device)
    u = torch.rand((b,), generator=generator, device=device)
    return t, u, torch.randn(shape, generator=generator, device=device)


def sr3_loss(diff: SR3Diffusion, model, hr: torch.Tensor,
             sr_bicubic: torch.Tensor, t: torch.Tensor | None = None,
             u: torch.Tensor | None = None, noise: torch.Tensor | None = None,
             generator: torch.Generator | None = None,
             loss_type: str = "l1") -> torch.Tensor:
    """The continuous-noise-level training loss (JAX sr3_loss, the
    reference's p_losses): t ~ U{1..T}, gamma ~ U[sqrt_acp_prev[t-1],
    sqrt_acp_prev[t]] (gamma = lo + u * (hi - lo)), x_noisy = gamma * HR +
    sqrt(1 - gamma^2) * noise, and the L1 (or L2) sum of noise - eps_hat
    over hr.numel(). hr, sr_bicubic [N, H, W, 3] in [-1, 1]. t [N] long,
    u [N] and noise (as hr) are drawn from `generator` unless given (a
    test feeds JAX's split(rng, 3) draws)."""
    buf = diff.buffers
    b, dev = hr.shape[0], hr.device
    if t is None or u is None or noise is None:
        dt, du, dn = sr3_draws(diff, tuple(hr.shape), generator, dev)
        t = dt if t is None else t
        u = du if u is None else u
        noise = dn if noise is None else noise
    prev = buf.sqrt_alphas_cumprod_prev.to(dev, torch.float32)
    t = t.to(dev, torch.long)
    lo, hi = prev[t - 1], prev[t]
    gamma = lo + u.to(dev, torch.float32) * (hi - lo)
    g = gamma.reshape(b, 1, 1, 1)
    nchw = lambda x: x.to(dev, torch.float32).permute(0, 3, 1, 2)
    noise = nchw(noise)
    x_noisy = g * nchw(hr) + torch.sqrt(1.0 - g ** 2) * noise
    eps_hat = model(torch.cat([nchw(sr_bicubic), x_noisy], dim=1),
                    gamma.reshape(b, 1))
    err = noise - eps_hat
    loss = err.abs().sum() if loss_type == "l1" else (err ** 2).sum()
    return loss / float(hr.numel())
