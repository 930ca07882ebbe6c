"""Fault-tolerant training loop, the reference's ``train/trainer.py``:
checkpoint/restart with async writes, straggler detection (per-step wall
time against an EMA), elastic restore (checkpoints hold whole leaves;
``shardings`` lays them out on ``mesh``, whatever mesh saved them),
SIGTERM preemption, and the data pipeline's step carried in the
checkpoint so a restart replays the exact stream.

The step runs eagerly on ``device`` (``cuda`` unless given), through the
kernels' ``autograd.Function``s there, and updates the parameters in
place (``optim/adamw.py``).  Its time is honest: ``loss.item()`` waits for
the device.  Weights come from ``init_params`` with an explicit
``torch.Generator`` (seeded ``tcfg.seed`` on ``device`` unless given).
The stub frontend of a config with ``n_frontend_tokens`` is 0.02 N(0, 1)
from a ``torch.Generator`` seeded ``seed * 100003 + step`` on ``device``
-- the reference draws it from ``jax.random``, so the two packages'
frontends differ (tests hand both one numpy frontend).
"""

from __future__ import annotations

import os
import signal
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models import layers as L
from repro_torch.models.model import init_params
from repro_torch.optim.adamw import adamw_init, cosine_schedule
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.train_step import make_train_step


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_async: bool = True
    log_every: int = 10
    straggler_factor: float = 3.0   # step > factor*EMA => flag
    ema_alpha: float = 0.2
    seed: int = 0
    lr_peak: float = 3e-4


@dataclass
class StragglerMonitor:
    """Flags abnormally slow steps -- on a real cluster this feeds the
    controller that triggers hot-spare swap / bad-host eviction."""

    factor: float = 3.0
    alpha: float = 0.2
    ema: Optional[float] = None
    events: List[Dict] = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        slow = self.ema is not None and dt > self.factor * self.ema
        if slow:
            self.events.append({"step": step, "dt": dt, "ema": self.ema})
        # don't poison the EMA with the outlier
        if not slow:
            self.ema = dt if self.ema is None else \
                (1 - self.alpha) * self.ema + self.alpha * dt
        return slow


def stub_frontend(cfg: ArchConfig, batch: int, seed: int, step: int,
                  device) -> torch.Tensor:
    """The stub modality frontend (precomputed embeddings) of ``step``:
    ``(batch, n_frontend_tokens, d_model)`` 0.02 N(0, 1) in the config's
    dtype, from a generator seeded ``seed * 100003 + step``."""
    gen = torch.Generator(device=device).manual_seed(seed * 100003 + step)
    return (0.02 * torch.randn((batch, cfg.n_frontend_tokens, cfg.d_model),
                               generator=gen, device=device)
            ).to(L.torch_dtype(cfg.dtype))


class Trainer:
    def __init__(self, cfg: ArchConfig, tcfg: TrainerConfig,
                 data_cfg: Optional[DataConfig] = None, mesh=None,
                 shardings=None, device=None,
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.shardings = shardings
        self.device = torch.device(device if device is not None else "cuda")
        self.generator = generator
        self.data = TokenPipeline(data_cfg or DataConfig(
            vocab=cfg.vocab, seq_len=64, global_batch=8, seed=tcfg.seed))
        self.ckpt = CheckpointManager(tcfg.ckpt_dir)
        self.monitor = StragglerMonitor(tcfg.straggler_factor, tcfg.ema_alpha)
        self.step_fn = make_train_step(
            cfg, lr=cosine_schedule(tcfg.lr_peak, warmup=20,
                                    total=tcfg.steps))
        self._preempted = False
        self.history: List[Dict] = []

    # -- preemption: SIGTERM triggers checkpoint-and-exit --

    def install_preemption_handler(self):
        def _handler(signum, frame):
            self._preempted = True
        signal.signal(signal.SIGTERM, _handler)

    # -- state --

    def init_state(self):
        gen = self.generator
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(
                self.tcfg.seed)
        params = init_params(self.cfg, gen, device=self.device)
        return params, adamw_init(params)

    def try_restore(self):
        """Elastic restart: resume from the latest checkpoint if present."""
        if self.ckpt.latest_step() is None:
            return None
        params, opt = self.init_state()
        state, meta = self.ckpt.restore({"params": params, "opt": opt},
                                        shardings=self.shardings,
                                        mesh=self.mesh)
        start = int(meta["extra"]["data_step"])
        return state["params"], state["opt"], start

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The pipeline's batch for ``step`` on the device, with the stub
        frontend where the config takes one."""
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in self.data.batch(step).items()}
        if self.cfg.n_frontend_tokens:
            batch["frontend"] = stub_frontend(
                self.cfg, batch["tokens"].shape[0], self.tcfg.seed, step,
                self.device)
        return batch

    # -- loop --

    def run(self, start_step: int = 0, params=None, opt_state=None,
            max_steps: Optional[int] = None) -> Dict[str, Any]:
        if params is None:
            restored = self.try_restore()
            if restored is not None:
                params, opt_state, start_step = restored
            else:
                params, opt_state = self.init_state()
        steps = max_steps if max_steps is not None else self.tcfg.steps
        step = start_step
        while step < steps and not self._preempted:
            batch = self.batch(step)
            t0 = time.perf_counter()
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      batch)
            loss = metrics["loss"].item()   # waits: honest step timing
            dt = time.perf_counter() - t0
            slow = self.monitor.observe(step, dt)
            rec = {"step": step, "loss": loss, "dt": dt, "straggler": slow}
            self.history.append(rec)
            if step % self.tcfg.log_every == 0:
                print(f"[train] step={step} loss={loss:.4f} dt={dt*1e3:.0f}ms"
                      + (" STRAGGLER" if slow else ""))
            step += 1
            if step % self.tcfg.ckpt_every == 0 or self._preempted:
                self.ckpt.save(step, {"params": params, "opt": opt_state},
                               extra={"data_step": step,
                                      **self.data.state_dict(step)},
                               async_=self.tcfg.ckpt_async)
        self.ckpt.wait()
        if self._preempted:
            self.ckpt.save(step, {"params": params, "opt": opt_state},
                           extra={"data_step": step})
        return {"params": params, "opt": opt_state, "step": step,
                "history": self.history,
                "straggler_events": self.monitor.events}
