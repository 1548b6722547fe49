"""One run of one cell: set-up, the measured window, the check, the line.

Everything a cell is sits in files that this module finds by name:
``BENCHMARK.json`` at the checkout's root (the cells and metrics),
``configs/<config>.json`` (the model and its optimizer),
``traffic/<traffic>.json`` (batch, sequence, token mix, and the save or
resume cadence), ``workloads/<cell>.json`` (the cell's limits and the
reference's block of rows) and ``metrics/<metric>.py`` (each metric's
reader). The program is driven only through
``repro_torch.train.trainer.Trainer``.

Training (a traffic without ``resume``): set-up makes the train state from
the seed, drives the trainer through the three steps that the reference
follows, times ``warm_steps`` more, and with saves makes one warm save;
the window is one ``Trainer.run`` of as many steps as fill ``--seconds``
at the warm step time, with two saves at about a third and two thirds
of it when the traffic saves, and ends when the last save has committed.
Resumes (``resume`` in the traffic): set-up trains the same first steps,
commits one checkpoint and makes one warm resume; the window repeats, as
many times as fill ``--seconds``: a fresh ``Trainer`` on that directory,
``initial_state()`` (the restore onto the card), and
``resume.steps_per_resume`` steps without saves.

The trainer logs at its own cadence, and every step with ``--trace 1``.
Each save's state and each restored state are digested on the card when
the save is handed them or the restore returns them; those kernels' time,
taken by events, is left out of the window and of ``resume_s``.

After the window: the peak memory is read, the program's state freed, and
the reference follows the first three steps from the same weights and
batches; the checkpoint's files are read back and held against the
state that was saved and against every restored state (digests, exact).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import statistics
import sys
import time
from pathlib import Path

import torch

from .feed import Feed
from .flops import H100_BF16_PEAK, train_step_flops
from .reference import adamw as ref_adamw
from .reference import ckpt_reader
from .reference import model as ref_model
from .weights import leaves, make_state, make_weights

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NO_SAVE = 1 << 40               # a save cadence that never comes


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def cell_files(spec: dict, name: str, base: Path = HERE,
               root: Path = ROOT) -> dict:
    """The cell's entry, workload, config and traffic, found by name."""
    cell = next(w for w in spec["workloads"] if w["name"] == name)
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    return {"cell": cell,
            "workload": load_json(base / "workloads" / f"{name}.json"),
            "config": load_json(root / conf["file"]),
            "traffic": load_json(base / "traffic"
                                 / f"{cell['traffic']}.json")}


def metrics_for(spec: dict, name: str, trace: bool) -> list[dict]:
    """The metrics a run of cell ``name`` reports: the end-to-end ones
    with ``--trace 0``, the per-layer ones with ``--trace 1``."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def load_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{len(name)}_{abs(hash(name))}",
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def model_config(model: dict):
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                          for k, v in model.items()})


class Run:
    """One run of one cell (module docstring)."""

    def __init__(self, spec: dict, name: str, seed: int, seconds: float,
                 trace: bool, t_start: float, device="cuda",
                 base: Path = HERE, root: Path = ROOT):
        self.name, self.seed = name, seed
        self.seconds, self.trace, self.t_start = seconds, trace, t_start
        self.device = device
        f = cell_files(spec, name, base, root)
        self.cell, self.work = f["cell"], f["workload"]
        self.conf, self.traffic = f["config"], f["traffic"]
        self.m = self.conf["model"]
        self.run_dir = root / ".portbench_run" / \
            f"{name}-{seed}-{os.getpid()}"
        self.ckpt_dir = self.run_dir / "ckpt"
        self.digests: dict = {}      # saved step -> {key: (2,) digest}
        self.digest_clock: list = []  # each digest's (start, end) events
        self.restored: list = []     # each resume's {key: (2,) digest}
        self.ctx: dict = {"saves": [], "resumes": [], "step_seconds": []}
        self.spans: list = []
        self.save_logs: list = []    # every trainer's SaveMetrics

    # ------------------------------------------------------------ program
    def _trainer(self, ckpt_every: int):
        from repro_torch.core import EngineConfig
        from repro_torch.optim import AdamWConfig
        from repro_torch.train.trainer import Trainer, TrainerConfig
        save = self.traffic.get("save", {})
        tc = TrainerConfig(
            steps=0, ckpt_every=ckpt_every, ckpt_dir=str(self.ckpt_dir),
            ckpt_engine=save.get("engine", "aggregated"),
            async_ckpt=save.get("async", True), keep=save.get("keep", 3),
            seed=self.seed)
        if self.trace:                 # step_ms and the spans read each step
            tc.log_every = 1
        tr = Trainer(self.cfg, tc,
                     opt_cfg=AdamWConfig(**self.conf["optimizer"]),
                     engine_config=EngineConfig(**save.get("engine_config",
                                                           {})),
                     device=self.device)
        tr.pipeline = self.feed            # the benchmark's traffic
        tr.on_log = self._on_log
        self._watch_saves(tr)
        self._tr = tr
        self.save_logs.append(tr.save_log)
        return tr

    def _watch_saves(self, tr) -> None:
        """Digest the state each save is handed, before the save reads it."""
        if tr.ckpt is None:
            return
        real = tr.ckpt.save

        def save(step, state, **kw):
            self.digests[step] = self._digest(state["train"])
            return real(step, state, **kw)
        tr.ckpt.save = save

    def _on_log(self, m: dict) -> None:
        """After every logged step: its span and the window's hook."""
        if self.trace:
            now = self.clock()
            self.spans.append(("step", now - m["seconds"], now, "main"))
        self._log_hook(m["step"])

    def _log_hook(self, step: int) -> None:
        """Per-window bookkeeping (set by the window)."""

    def digest_state(self, state) -> dict:
        return {"train/" + k: ckpt_reader.digest(v)
                for k, v in leaves(state).items()}

    def _digest(self, state) -> dict:
        """``digest_state``, its time noted so that the window and the
        resumes leave it out: on the card, events around its kernels,
        which run in stream order between the step and the save."""
        if self.device != "cuda":
            t0 = time.perf_counter()
            out = self.digest_state(state)
            self.digest_clock.append(time.perf_counter() - t0)
            return out
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = self.digest_state(state)
        b.record()
        self.digest_clock.append((a, b))
        return out

    def _digest_seconds(self, since: int = 0) -> float:
        """Seconds the digests from number ``since`` on took."""
        out = 0.0
        for d in self.digest_clock[since:]:
            if isinstance(d, tuple):
                d[1].synchronize()
                d = d[0].elapsed_time(d[1]) / 1e3
            out += d
        return out

    def _run_steps(self, tr, start: int, stop: int) -> dict:
        tr.tcfg.steps = stop
        return tr.run((self.state, start))

    # ------------------------------------------------------------- set-up
    def setup(self) -> None:
        self.first_steps()
        self.warm()

    def first_steps(self) -> None:
        """The state from the seed and the three steps the reference
        follows, through the trainer's own call and feed."""
        from repro_torch.core import trace as T
        from repro_torch.train.steps import init_train_state
        self.clock = T.clock
        ref_model.exact_matmuls()      # float32 is float32: TF32 off
        self.cfg = model_config(self.m)
        self.layout = init_train_state(self.cfg, device="meta")
        self.feed = Feed(self.traffic, self.m, self.seed, self.device)
        self.state = make_state(self.layout, self.seed, self.device)
        tr = self._trainer(NO_SAVE if "save" in self.traffic else 0)
        log_every, tr.tcfg.log_every = tr.tcfg.log_every, 1
        self._run_steps(tr, 0, 1)
        b1 = self.conf["optimizer"]["b1"]
        self.prog_grad = {k: torch.linalg.vector_norm(v) / (1 - b1)
                          for k, v in leaves(self.state["opt"]["mu"]).items()}
        self._run_steps(tr, 1, 3)
        w0 = make_weights(self.layout["params"], self.seed, self.device)
        self.prog_change = {
            k: torch.linalg.vector_norm(v.float() - w0[k].float())
            for k, v in leaves(self.state["params"]).items()}
        del w0
        self.prog_loss = [e["loss"] for e in tr.metrics_log[:3]]
        tr.tcfg.log_every = log_every
        self.tr = tr

    def warm(self) -> None:
        """Timed warm steps; a warm save, or a checkpoint and a warm
        resume."""
        tr = self.tr
        saves = "save" in self.traffic
        n = self.work["warm_steps"]
        t0 = time.perf_counter()
        self._run_steps(tr, 3, 3 + n)
        self.t_step = (time.perf_counter() - t0) / n
        self.w = 3 + n
        if saves:                      # one warm save, at step w + 1
            tr.tcfg.ckpt_every = self.w + 1
            self._run_steps(tr, self.w, self.w + 1)
            self.w += 1
            tr.tcfg.ckpt_every = NO_SAVE
        if "resume" in self.traffic:
            self.saved_step = self.w
            tr.close()
            self.state = None
            self._tr = None
            gc.collect()
            t0 = time.perf_counter()
            self._resume_cycle(record=False)
            self.t_cycle = time.perf_counter() - t0
        self.tr = self._tr

    # ------------------------------------------------------------- window
    def window(self) -> None:
        from repro_torch.core import trace as T
        from .devtrace import Stretch
        self.stretch = Stretch(self.clock) if self.trace else None
        if self.trace:
            T.enable()
        self.t_window = time.perf_counter()
        self.ctx["setup_s"] = self.t_window - self.t_start
        first_digest = len(self.digest_clock)
        if "resume" in self.traffic:
            self._window_resumes()
        else:
            self._window_train()
        wall = time.perf_counter() - self.t_window
        self.ctx["digest_s"] = self._digest_seconds(first_digest)
        self.ctx["window_s"] = wall - self.ctx["digest_s"]
        if self.trace:
            for e in T.drain():
                if e.kind == "span":
                    self.spans.append((e.name, e.t0, e.t1, e.thread))
            T.disable()
        if self.stretch is not None and self.stretch.open:
            self.stretch.end()

    def _window_train(self) -> None:
        tr, w = self.tr, self.w
        N = max(3, round(self.seconds / self.t_step))
        K = 0
        if "save" in self.traffic and self.traffic["save"]["in_window"]:
            N = max(N, 3 * w + 3)     # room for both saves after step w
            K = (N + w) // 3 + 1      # saves at K and 2K, none at 3K
            tr.tcfg.ckpt_every = K
        lo, hi = self._stretch_steps(N, K)
        first_window_log = len(tr.metrics_log)

        def hook(step):
            if self.stretch is None:
                return
            if step == w + lo - 1:
                self.stretch.begin()
            if step == w + hi - 1:
                self.stretch.end()
        if lo == 0 and self.stretch is not None:
            self.stretch.begin()
        self._log_hook = hook
        saves_before = len(tr.save_log)
        out = self._run_steps(tr, w, w + N)
        self.ctx["saves"] = tr.save_log[saves_before:]
        self.ctx["ckpt_blocking_s"] = out["ckpt_blocking_seconds"]
        self.ctx["snapshot_wait_s"] = out["ckpt_snapshot_wait_seconds"]
        self.ctx["step_seconds"] = [e["seconds"] for e in
                                    tr.metrics_log[first_window_log:]]
        self.ctx["attempted"] = N
        self.ctx["tokens"] = N * self.traffic["batch"] * self.traffic["seq_len"]

    def _stretch_steps(self, N: int, K: int) -> tuple[int, int]:
        """Window steps [lo, hi) that the traced run profiles: a tenth of
        the window (3 steps at least), around the first save if any."""
        n = max(3, N // 10)
        mid = (K - self.w) if K else N // 2
        lo = max(0, min(N - n, mid - n // 2))
        return lo, lo + n

    def _resume_cycle(self, record: bool = True) -> None:
        """A fresh trainer on the checkpoint, the restore, the steps."""
        from repro_torch.core import trace as T
        t0 = time.perf_counter()
        self._log_hook = lambda step: None
        with T.span("portbench.trainer_init"):
            tr = self._trainer(NO_SAVE)
        with T.span("portbench.initial_state"):
            state, start = tr.initial_state()
        self.state = state
        first_digest = len(self.digest_clock)
        if record:
            self.restored.append(self._digest(state))
        spr = self.traffic["resume"]["steps_per_resume"]
        self._run_steps(tr, start, start + 1)
        t_first = time.perf_counter()       # run() ends synchronised
        self._run_steps(tr, start + 1, start + spr)
        if record:
            self.ctx["resumes"].append({
                "resume_s": t_first - t0
                - self._digest_seconds(first_digest), **tr.restore_attr,
                "restore_metrics": tr.ckpt.last_restore_metrics})
            self.ctx["step_seconds"] += [e["seconds"]
                                         for e in tr.metrics_log]
        tr.close()
        self.state = None
        self._tr = None

    def _window_resumes(self) -> None:
        R = max(1, round(self.seconds / self.t_cycle))
        mid = R // 2
        for i in range(R):
            if self.stretch is not None and i == mid:
                self.stretch.begin()
            self._resume_cycle()
            if self.stretch is not None and i == mid:
                self.stretch.end()
        spr = self.traffic["resume"]["steps_per_resume"]
        self.ctx["attempted"] = R
        self.ctx["tokens"] = R * spr * self.traffic["batch"] \
            * self.traffic["seq_len"]

    # -------------------------------------------------------------- check
    def free_program(self) -> None:
        if self.tr is not None:
            self.tr.close()
        self.tr = self._tr = self.state = None
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "fp32", batches=None) -> dict:
        """The first three steps, from the same weights and batches
        (``batches``: a change made to each, for the check's faults)."""
        ref_model.exact_matmuls()
        w0 = make_weights(self.layout["params"], self.seed, self.device)
        dtypes = {k: v.dtype for k, v in w0.items()}
        p = {k: v.to(torch.float32, copy=True) for k, v in w0.items()}
        opt = ref_adamw.AdamW(p, dtypes, self.conf["optimizer"])
        feed = Feed(self.traffic, self.m, self.seed, self.device)
        losses, grad = [], None
        for t in range(3):
            batch = feed.batch_at(t)
            if batches is not None:
                batch = batches(batch)
            loss, grads = ref_model.loss_and_grads(
                p, self.m, batch, rows=self.work["reference_rows"],
                precision=precision)
            losses.append(float(loss))
            norms = opt.step(p, grads)
            del grads
            if t == 0:
                grad = norms
        change = {k: torch.linalg.vector_norm(p[k] - w0[k].float())
                  for k in p}
        return {"loss": losses, "grad": grad, "change": change}

    def compare(self, ref: dict, prog: dict | None = None) -> dict:
        """The numbers that can decide ``correct`` (PERF.md names them):
        the worst of the first two steps' losses against the reference's
        (the third's, which swings with round-off that Adam's first
        updates amplify, is reported apart; the change covers its step);
        the first gradient's and the three steps' change's norms by leaf,
        the worst leaf and the median leaf, each gap over the larger of
        the reference's norm of that leaf and of the median leaf. Leaves
        whose reference gradient is under a thousandth of the median
        leaf's are left out of the change."""
        prog = prog or {"loss": self.prog_loss, "grad": self.prog_grad,
                        "change": self.prog_change}
        losses = [abs(a - b) / abs(b)
                  for a, b in zip(prog["loss"], ref["loss"])]
        out = {"loss_gap": max(losses[:2]), "loss3_gap": losses[2]}
        g_ref = {k: float(v) for k, v in ref["grad"].items()}
        g_med = statistics.median(g_ref.values())
        moved = [k for k, g in g_ref.items() if g >= 1e-3 * g_med]
        for name, keys in (("grad", list(g_ref)), ("change", moved)):
            r = {k: float(ref[name][k]) for k in keys}
            med = statistics.median(r.values())
            gaps = [abs(float(prog[name][k]) - v) / max(v, med)
                    for k, v in r.items()]
            out[f"{name}_gap"] = max(gaps)
            out[f"{name}_median_gap"] = statistics.median(gaps)
        return out

    def check_checkpoints(self) -> dict:
        """Every committed step against the state digested when it was
        saved, and every restored state against its file; the count of
        leaves that differ, and of steps or leaves that are missing."""
        out = {}
        if "save" not in self.traffic:
            return out
        steps = ckpt_reader.committed_steps(str(self.ckpt_dir)) \
            if self.ckpt_dir.is_dir() else []
        # the warm save and the window's, each digested when it was made
        bad = max(0, 1 + self.traffic["save"]["in_window"]
                  - len(self.digests))
        expect = sorted(self.digests)[-self.traffic["save"].get("keep", 3):]
        files = {}
        for s in expect:
            if s not in steps:
                bad += 1
                continue
            try:
                files[s] = ckpt_reader.step_digests(str(self.ckpt_dir), s,
                                                    self.device)
            except (ValueError, OSError):
                bad += 1
                continue
            want = self.digests[s]
            bad += sum(1 for k in set(want) | set(files[s])
                       if k not in want or k not in files[s]
                       or not torch.equal(want[k], files[s][k]))
        out["saved_leaves_differing"] = bad
        if "resume" in self.traffic:
            f = files.get(self.saved_step, {})
            out["restored_leaves_differing"] = sum(
                sum(1 for k in set(f) | set(r)
                    if k not in f or k not in r or not torch.equal(f[k], r[k]))
                for r in self.restored) + (0 if self.restored else 1)
            self.ctx["failed"] = sum(
                1 for r in self.restored
                if any(k not in f or not torch.equal(f[k], r[k]) for k in r))
        return out


def correct_numbers(run: Run) -> dict:
    """{name: (value, limit)} of every number compared."""
    nums = run.compare(run.reference())
    nums.update(run.check_checkpoints())
    limits = run.work["limits"]
    return {k: (nums[k], lim) for k, lim in limits.items()}


def device_info(count: int, device="cuda") -> dict:
    if device != "cuda":                 # the check's own tests
        return {"platform": device, "kind": device, "count": count,
                "memory_peak_bytes": 0}
    torch.cuda.synchronize()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def run_cell(spec: dict, name: str, seed: int, seconds: float, trace: bool,
             t_start: float, log=print, device="cuda", base: Path = HERE,
             root: Path = ROOT) -> dict:
    """Set-up, window, check; the result line's object."""
    run = Run(spec, name, seed, seconds, trace, t_start, device, base, root)
    try:
        run.setup()
        run.window()
        dev = device_info(run.cell["chips"], device)
        if trace:
            read = run.stretch.read(run.spans)
            dev["busy_s"], dev["window_s"] = read["busy_s"], read["window_s"]
            run.ctx["devtrace"] = read
        run.free_program()
        nums = correct_numbers(run)
        if run.digests:
            saves = [m for logs in run.save_logs for m in logs]
            log(f"checkpoint directory {run.ckpt_dir} on "
                f"{fs_type(run.ckpt_dir)}: {len(saves)} saves wrote "
                f"{sum(m.written_bytes for m in saves)} bytes")
    finally:
        shutil.rmtree(run.run_dir, ignore_errors=True)
        try:
            run.run_dir.parent.rmdir()         # when no other run uses it
        except OSError:
            pass
    return result_line(spec, run, dev, nums)


def result_line(spec: dict, run: Run, dev: dict, nums: dict) -> dict:
    """The object printed as the run's last line."""
    ctx = run.ctx
    ctx["flops"] = ctx["tokens"] / run.traffic["seq_len"] \
        / run.traffic["batch"] * train_step_flops(
            run.m, run.traffic["batch"], run.traffic["seq_len"])
    ctx["peak_flops"] = H100_BF16_PEAK
    metrics = {}
    for m in metrics_for(spec, run.name, run.trace):
        v = load_reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": all(v <= lim for v, lim in nums.values()),
           "attempted": ctx["attempted"], "failed": ctx.get("failed", 0),
           "metrics": metrics, "device": dev}
    if run.trace:
        out["breakdown"] = {"device_ops": ctx["devtrace"]["device_ops"],
                            "idle_gaps": ctx["devtrace"]["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in nums.items()}
    return out


def fs_type(path: Path) -> str:
    """The type of the filesystem that holds ``path`` (from /proc/mounts)."""
    best, kind = "", "unknown"
    p = str(Path(path).resolve())
    try:
        with open("/proc/mounts", encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if len(parts) > 2 and (p == parts[1] or p.startswith(
                        parts[1].rstrip("/") + "/")) and \
                        len(parts[1]) > len(best):
                    best, kind = parts[1], parts[2]
    except OSError:
        pass
    return kind


def written_bytes() -> int | None:
    """Bytes this process has caused to be written to storage."""
    try:
        with open("/proc/self/io", encoding="utf-8") as f:
            for line in f:
                if line.startswith("write_bytes:"):
                    return int(line.split()[1])
    except OSError:
        return None
    return None


def jax_modules() -> list[str]:
    banned = {"jax", "jaxlib", "flax", "repro"}
    return sorted({m.split(".")[0] for m in list(sys.modules)} & banned)


