"""SR3 Stage-1 training (rsvldm_tpu/training/sr3_trainer.py): Adam on the
UNet, the EMA updated every step, checkpoints and resume.

The hyperparameters are the reference's configs/sr_sr3.json (Adam 1e-4,
EMA 0.9999, a linear train schedule of 2000 steps over [1e-6, 1e-2], L1).
The EMA starts at the first step: JAX's trainer keeps `step_start_ema` in
its config and never reads it, and so does this one. Parameters and the
step are fp32 on the trainer's device.

Checkpoints are the reference's save_network files: <dir>/I{step}_gen.pth,
the UNet's state_dict under the reference names (what the pipeline's SR3
loader reads), and I{step}_opt.pth with the iteration, the optimizer, the
EMA parameters and the EMA's step. JAX's orbax checkpoints are not read.

Data parallelism (`mesh=`, JAX sr3_trainer.py:47-93): the state is
broadcast from the mesh's first rank; each rank takes its rows of the
global batch (local_batch_range), draws the loss's t, u and noise for the
whole global batch from the step's key (the same on every rank) and keeps
its rows, so a row gets the draws it would get in one process; the
gradients are averaged over the mesh (one all-reduce of them all) before
Adam, so the parameters and the EMA stay equal on every rank; the loss
returned is the global batch's. The mesh's first rank writes the checkpoints.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Iterator, Optional

import torch

from ..models.sr3.diffusion import SR3Diffusion, sr3_draws, sr3_loss
from ..models.sr3.unet import SR3UNet, SR3UNetConfig
from ..utils import prng
from ..utils.jax_init import flax_init
from .ema import EmaState, ema_init, ema_update


@dataclasses.dataclass
class SR3TrainConfig:
    lr: float = 1e-4
    ema_decay: float = 0.9999
    schedule: str = "linear"
    n_timestep: int = 2000
    linear_start: float = 1e-6
    linear_end: float = 1e-2
    loss_type: str = "l1"
    save_every: int = 100_000


class SR3Trainer:
    """model_cfg / train_cfg as JAX's. The UNet starts from `state_dict`
    when given, else from Flax's init of PRNGKey(seed) (utils/jax_init.py),
    the weights JAX's SR3Trainer(rng=PRNGKey(seed)) starts from. The loss
    draws are JAX's, from keys (utils/prng.py): `fit` splits its key once
    a step, as JAX's fit."""

    def __init__(self, model_cfg: SR3UNetConfig, train_cfg: SR3TrainConfig,
                 device: str | torch.device = "cuda",
                 seed: int = 0, state_dict: dict | None = None,
                 mesh=None):
        self.model_cfg = model_cfg
        self.mesh = mesh
        self.cfg = train_cfg
        self.device = torch.device(device)
        self.model = SR3UNet(model_cfg).to(self.device)
        if state_dict is None:
            state_dict = flax_init("sr3", model_cfg, prng.key(seed),
                                   self.device)
        self.model.load_state_dict(state_dict)
        if mesh is not None:
            from ..parallel.mesh import mesh_group, replicate_state
            replicate_state(mesh, self.model)
            self.group = mesh_group(mesh)
        self.diff = SR3Diffusion.from_schedule(
            train_cfg.schedule, train_cfg.n_timestep, train_cfg.linear_start,
            train_cfg.linear_end)
        self.opt = torch.optim.Adam(self.model.parameters(), lr=train_cfg.lr,
                                    betas=(0.9, 0.999), eps=1e-8)
        self.ema: EmaState = ema_init(dict(self.model.named_parameters()))
        self.step = 0

    def train_step(self, hr, sr, t=None, u=None, noise=None,
                   key: prng.Key | None = None) -> float:
        """hr / sr: [N, H, W, 3] in [-1, 1] (the HR target and the bicubic
        upsampled LR). t, u, noise: sr3_loss's draws, else JAX's of `key`
        (sr3_draws). With a mesh, hr / sr are this rank's rows and t, u,
        noise (given or drawn) the whole global batch's."""
        as_dev = lambda x: torch.as_tensor(x).to(self.device, torch.float32)
        hr, sr = as_dev(hr), as_dev(sr)
        if self.mesh is not None:
            return self._dp_step(hr, sr, t, u, noise, key)
        loss = sr3_loss(self.diff, self.model, hr, sr, t, u,
                        noise, key, self.cfg.loss_type)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self._update()
        return float(loss.detach())

    def _dp_step(self, hr, sr, t, u, noise, key) -> float:
        from ..parallel.distributed import all_reduce, all_reduce_grads
        from ..parallel.mesh import batch_sharding, mesh_size
        n = mesh_size(self.mesh)
        shape = (hr.shape[0] * n, *hr.shape[1:])
        if t is None or u is None or noise is None:
            t, u, noise = sr3_draws(self.diff, shape, key, self.device)
        rows = batch_sharding(self.mesh, shape[0])
        loss = sr3_loss(self.diff, self.model, hr, sr, t[rows], u[rows],
                        noise[rows], None, self.cfg.loss_type)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_grads([p for p in self.model.parameters()
                          if p.grad is not None], self.group, n)
        self._update()
        return float(all_reduce(loss.detach().clone(), self.group) / n)

    def _update(self):
        self.opt.step()
        ema_update(self.ema, dict(self.model.named_parameters()),
                   self.cfg.ema_decay)
        self.step += 1

    def fit(self, data_iter: Iterator, steps: int,
            key: prng.Key | None = None, log_every: int = 100,
            save_dir: str | None = None,
            on_step: Optional[Callable[[dict], None]] = None):
        """`steps` steps over (hr, sr) batches. Step i's draws are JAX's:
        key, sub = split(key) (key default PRNGKey(0)), then sr3_loss's of
        sub. Prints 'step {n}: loss {x:.5f}' every log_every steps, as
        JAX's."""
        key = prng.key(0) if key is None else key
        for i in range(steps):
            hr, sr = next(data_iter)
            key, sub = prng.split(key)
            loss = self.train_step(hr, sr, key=sub)
            if on_step is not None:
                on_step({"step": self.step, "loss": loss})
            if i % log_every == 0:
                print(f"step {self.step}: loss {loss:.5f}", flush=True)
            if save_dir and self.step % self.cfg.save_every == 0:
                self.save(save_dir)
        return self

    def save(self, directory: str | Path):
        if self.mesh is not None:
            from ..parallel.mesh import mesh_index
            if mesh_index(self.mesh):
                return
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        torch.save(self.model.state_dict(), d / f"I{self.step}_gen.pth")
        torch.save({"iter": self.step, "optimizer": self.opt.state_dict(),
                    "ema": self.ema.params, "ema_step": self.ema.step},
                   d / f"I{self.step}_opt.pth")

    def load(self, directory: str | Path, it: int):
        d = Path(directory)
        load = lambda p: torch.load(p, map_location=self.device,
                                    weights_only=True)
        self.model.load_state_dict(load(d / f"I{it}_gen.pth"))
        state = load(d / f"I{it}_opt.pth")
        self.opt.load_state_dict(state["optimizer"])
        self.ema = EmaState({k: v.to(self.device)
                             for k, v in state["ema"].items()},
                            int(state["ema_step"]))
        self.step = int(state["iter"])
        return self
