"""SR3 Gaussian diffusion's ancestral reverse loop (the port's
models/sr3/diffusion.py without its DDIM sampler): one step function on
the loop's tensors (the latent, a step counter, the schedule scalars as
[steps] tables read at that counter, and the noise laid out as JAX's
`noise_override`: [0] is x_T, [1+i] the noise of loop step i, multiplied
by a tabled 0 where JAX zeroes it), called once a step. Tables are
float32, as JAX's."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .schedules import DDPMBuffers, ddpm_buffers, make_beta_schedule
from .runner import StepRunner, use_graphs


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
