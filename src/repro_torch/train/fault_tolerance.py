"""Fault tolerance: supervised training loop with checkpoint/restart,
straggler detection, and an elastic re-mesh plan.  Counterpart of
src/repro/train/fault_tolerance.py, pure Python over `checkpoint`.

At thousand-node scale the assumptions are: (a) some host WILL fail
mid-run, (b) some host WILL run slow (thermal, network), (c) the replacement
cluster may have a different device count.  The pieces here:

* `TrainSupervisor.run` — steps the train function, checkpoints every
  `ckpt_every` (async), and on any exception restores the latest checkpoint
  and continues (`max_restarts` budget).  Data is a pure function of step,
  so resume replays the same batches.
* `StragglerMonitor` — EWMA of step wall-time; flags steps slower than
  `threshold`× the running mean (logged + counted, hook exposed).
* `elastic_plan` — given old/new device counts, emits the re-mesh shape and
  whether the global batch must be re-split (checkpoints are host-side full
  arrays, so any mesh can load them).
* `LinkFault` / `FaultInjector` — a typed mid-step failure for a dead
  fabric link.  Unlike a host crash, the training state is intact when a
  link dies (the step raised before committing), so `TrainSupervisor`
  routes it to the `on_link_fault` hook — online schedule repair + hot
  swap (`repro_torch.comms.mesh_axes.CollectiveContext.hot_swap`) — and
  retries the *same* step without restoring a checkpoint.  The injector
  exists so tests and the launcher (``--inject-fault step:u-v``) can
  exercise that path deterministically.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import checkpoint as ckpt


class LinkFault(RuntimeError):
    """A fabric link (u, v) died mid-step.  Carries the transform text the
    repair path needs (``@fail(u-v)``)."""

    def __init__(self, u: int, v: int, message: Optional[str] = None):
        super().__init__(message or f"link {u}-{v} failed")
        self.u = int(u)
        self.v = int(v)

    @property
    def transform_text(self) -> str:
        return f"@fail({self.u}-{self.v})"


@dataclasses.dataclass
class FaultInjector:
    """Raise one `LinkFault` when training reaches `at_step` — the
    deterministic stand-in for a mid-run link failure."""
    at_step: int
    u: int
    v: int
    fired: bool = False

    @classmethod
    def parse(cls, text: str) -> "FaultInjector":
        """``"step:u-v"`` — e.g. ``"3:0-1"`` fails link 0-1 at step 3."""
        try:
            step_s, link = text.split(":", 1)
            u_s, v_s = link.split("-", 1)
            return cls(at_step=int(step_s), u=int(u_s), v=int(v_s))
        except ValueError as e:
            raise ValueError(
                f"malformed fault spec {text!r} (expected 'step:u-v')") from e

    def check(self, step: int) -> None:
        if not self.fired and step == self.at_step:
            self.fired = True
            raise LinkFault(self.u, self.v)


@dataclasses.dataclass
class StragglerMonitor:
    alpha: float = 0.2
    threshold: float = 2.0
    ewma: Optional[float] = None
    flagged: List[Tuple[int, float]] = dataclasses.field(default_factory=list)
    on_straggler: Optional[Callable[[int, float], None]] = None

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = (self.ewma is not None
                        and dt > self.threshold * self.ewma)
        if is_straggler:
            self.flagged.append((step, dt))
            if self.on_straggler:
                self.on_straggler(step, dt)
        # Clamp outliers to threshold× the mean instead of dropping them:
        # one spike still can't swamp the EWMA, but a *persistent* slowdown
        # walks the mean up geometrically until the new speed stops being
        # flagged (dropping flagged samples froze the mean at the old speed
        # and flagged every step forever).
        if self.ewma is None:
            self.ewma = dt
        else:
            capped = min(dt, self.threshold * self.ewma)
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * capped
        return is_straggler


def elastic_plan(old_devices: int, new_devices: int, global_batch: int,
                 model_parallel: int) -> Dict[str, Any]:
    """Re-mesh plan after losing/gaining hosts.  Keeps model parallelism
    fixed (param layout survives), resizes the data axis, and adjusts
    microbatching so the global batch is preserved when divisibility
    allows."""
    if new_devices % model_parallel:
        raise ValueError(
            f"{new_devices} devices cannot keep model_parallel="
            f"{model_parallel}")
    new_data = new_devices // model_parallel
    plan = {
        "mesh_shape": (new_data, model_parallel),
        "data_axis": new_data,
        "global_batch": global_batch,
        "microbatch_scale": 1,
    }
    if global_batch % new_data:
        # keep global batch by accumulating: the smallest scale with
        # new_data | global_batch·scale is new_data / gcd(global_batch,
        # new_data) — each of the `scale` accumulation passes feeds
        # global_batch·scale/new_data examples per data shard, and the
        # summed gradient covers exactly `global_batch` examples.
        plan["microbatch_scale"] = new_data // math.gcd(global_batch,
                                                        new_data)
    return plan


@dataclasses.dataclass
class TrainSupervisor:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    max_restarts: int = 3
    #: link faults take this path instead of checkpoint restore: the hook
    #: (typically `CollectiveContext.hot_swap` + logging) repairs the
    #: communication schedules for the degraded fabric, and the SAME step
    #: is retried on the intact state — no work is lost.  Budgeted
    #: separately from `max_restarts` (a repaired fabric is a recovery,
    #: not a crash).
    on_link_fault: Optional[Callable[[LinkFault], None]] = None
    max_link_faults: int = 3
    monitor: StragglerMonitor = dataclasses.field(
        default_factory=StragglerMonitor)

    def run(self, *, state: Any, num_steps: int,
            step_fn: Callable[[int, Any], Tuple[Any, Dict[str, Any]]],
            start_step: int = 0,
            log_every: int = 10,
            log: Callable[[str], None] = print) -> Tuple[Any, int]:
        """step_fn(step, state) -> (state, metrics).  Returns final state.

        Any exception triggers restore-from-latest + replay (data is pure
        in step, so replayed steps are identical) — except a `LinkFault`
        with `on_link_fault` set, which repairs in place and retries the
        step without touching checkpoints."""
        step = start_step
        restarts = 0
        link_faults = 0
        while step < num_steps:
            try:
                t0 = time.perf_counter()
                state, metrics = step_fn(step, state)
                dt = time.perf_counter() - t0
                if self.monitor.observe(step, dt):
                    log(f"[ft] straggler at step {step}: {dt:.3f}s "
                        f"(ewma {self.monitor.ewma:.3f}s)")
                if log_every and step % log_every == 0:
                    loss = metrics.get("loss")
                    log(f"step {step}: loss={float(loss):.4f} dt={dt:.3f}s"
                        if loss is not None else f"step {step}: dt={dt:.3f}s")
                step += 1
                if step % self.ckpt_every == 0 or step == num_steps:
                    ckpt.save_async(self.ckpt_dir, step, state)
                    ckpt.gc_old(self.ckpt_dir, self.keep)
            except KeyboardInterrupt:
                raise
            except LinkFault as e:
                if self.on_link_fault is None:
                    raise       # no repair path configured: a real crash
                link_faults += 1
                if link_faults > self.max_link_faults:
                    raise RuntimeError(
                        f"exceeded {self.max_link_faults} link faults") from e
                log(f"[ft] link fault at step {step} ({e}); repairing "
                    f"schedules in place (fault {link_faults}/"
                    f"{self.max_link_faults})")
                self.on_link_fault(e)
                # state is intact (the step raised before committing):
                # retry the same step on the repaired fabric, no restore
            except Exception as e:  # noqa: BLE001 — any failure: restart
                restarts += 1
                if restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded {self.max_restarts} restarts") from e
                ckpt.wait_pending()
                last = ckpt.latest_step(self.ckpt_dir)
                if last is None:
                    raise RuntimeError("failure before first checkpoint") \
                        from e
                log(f"[ft] step {step} failed ({type(e).__name__}: {e}); "
                    f"restoring step {last} (restart {restarts}/"
                    f"{self.max_restarts})")
                state, step = ckpt.restore(self.ckpt_dir, state, step=last)
        ckpt.wait_pending()
        return state, step
