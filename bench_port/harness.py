"""One run of one cell: build the program from the seed, warm its shapes,
fill its slots, drive the closed loop for the window, read the metrics,
then hold what the window served against the plain reference.

Everything that belongs to one configuration, cell, traffic mix, span or
metric sits in a file of its own under this folder, found by the name
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the HF ``config.json`` keys, the quantization
  and the assumptions;
- ``workloads/<cell>.json``: the engine's parameters, the traced stretch
  and the correctness check's sample and limit;
- ``traffic/<traffic>.json``: the mix (:mod:`bench_port.traffic`);
- ``spans/*.json`` and ``counters/*.py``: :mod:`bench_port.spans`;
- ``kernels/*.json``: the program's kernel function names by group, for
  the readers that find decode kernels by name;
- ``metrics/<metric>.py``: a reader ``read(run) -> float | None`` of a
  :class:`RunRecord`.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import resource
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import spans, trace
from . import weights as W
from .reference import model as ref_model
from .traffic import Req, Traffic

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Top-level module names a run may not have loaded.
BANNED = ("jax", "jaxlib", "flax", "quantizations_tpu")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "bf16x2": "bf16x2"}


def banned_modules(names=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`BANNED`, compared whole."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(BANNED))


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict          # the workload's entry in BENCHMARK.json
    work: dict           # workloads/<cell>.json
    config: dict         # configs/<config>.json
    traffic: dict        # traffic/<traffic>.json
    dims: W.Dims


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "bench_port"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> Cell:
        entry = next((w for w in self.spec["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        conf = next(c for c in self.spec["configs"]
                    if c["name"] == entry["config"])
        config = json.loads((self.root / conf["file"]).read_text())
        work = json.loads((self.dir / "workloads" / f"{name}.json")
                          .read_text())
        for k in ("config", "traffic"):
            if work.get(k, entry[k]) != entry[k]:
                raise ValueError(f"workloads/{name}.json names {k} "
                                 f"{work[k]!r}, BENCHMARK.json {entry[k]!r}")
        traffic = json.loads((self.dir / "traffic" /
                              f"{entry['traffic']}.json").read_text())
        return Cell(name, entry, work, config, traffic,
                    W.Dims.from_config(config))

    def metrics(self, cell: Cell, traced: bool) -> List[dict]:
        """The cell's end-to-end metrics, or its per-layer ones."""
        key = "per_layer" if traced else "end_to_end"
        return [m for m in self.spec[key]
                if "workloads" not in m or cell.name in m["workloads"]]

    def kernel_groups(self) -> Dict[str, List[str]]:
        """Kernel function names by group (``linear``, ``attn``), the
        union over ``kernels/*.json``: a later kernel adds a file."""
        out: Dict[str, List[str]] = {}
        for path in sorted((self.dir / "kernels").glob("*.json")):
            for group, names in json.loads(path.read_text()).items():
                out.setdefault(group, []).extend(names)
        return out

    def reader(self, metric: str):
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


# -- the program ---------------------------------------------------------

def program_config(cell: Cell):
    """The program's ``LlamaConfig``: HF keys through the program's own
    loader (``models/hf_loader.py config_from_hf``), then the
    quantization and KV pool the configuration file states."""
    from quantizations_tpu_torch.config import QuantConfig
    from quantizations_tpu_torch.models.hf_loader import config_from_hf

    q = cell.config["quant"]
    quant = QuantConfig(quant_type=q["quant_type"], blocksize=q["blocksize"],
                        compress_statistics=q["compress_statistics"],
                        scales_dtype=DTYPES[q["scales_dtype"]],
                        quantize_lm_head=q["quantize_lm_head"],
                        quantize_embedding=q["quantize_embedding"])
    with tempfile.TemporaryDirectory() as d:
        (Path(d) / "config.json").write_text(json.dumps(cell.config))
        cfg = config_from_hf(d, quant)
    return dataclasses.replace(cfg, kv_cache_dtype=cell.config["kv_cache_dtype"])


def build_program(cell: Cell, cfg, seed: int, device: torch.device):
    """The program's 4-bit model from the seeded weights, through its own
    build path: ``quantize_linear`` (K2) for each projection,
    ``stack_layers`` one layer at a time, ``fuse_projections``."""
    from quantizations_tpu_torch.models.llama import (
        LlamaLayer, LlamaParams, fuse_projections, quantize_linear,
        stack_layers)

    q, d = cfg.quant, cell.dims
    sigma = cell.config["weights"]["sigma"]

    def ql(w):
        return quantize_linear(w, blocksize=q.blocksize,
                               quant_type=q.quant_type,
                               compress_statistics=q.compress_statistics,
                               scales_dtype=q.scales_dtype)

    def ones():
        return torch.ones(d.hidden, dtype=torch.bfloat16, device=device)

    def make_layer(i):
        w = W.layer_weights(d, seed, i, device, sigma)
        return LlamaLayer(attn_norm=ones(), q=ql(w["q"]), k=ql(w["k"]),
                          v=ql(w["v"]), o=ql(w["o"]), mlp_norm=ones(),
                          gate=ql(w["gate"]), up=ql(w["up"]),
                          down=ql(w["down"]))

    layers = stack_layers(make_layer, d.layers, device)
    embed = W.head_weight(d, seed, "embed", device, sigma)
    head = W.head_weight(d, seed, "lm_head", device, sigma)
    params = LlamaParams(embed=embed, layers=layers, final_norm=ones(),
                         lm_head=ql(head) if q.quantize_lm_head else head)
    if cell.config.get("fuse_projections"):
        params = fuse_projections(params)
    return params


def make_engine(cell: Cell, cfg, params, seed: int):
    from quantizations_tpu_torch.serve.paged import PagedEngine

    e = cell.work["engine"]
    return PagedEngine(params, cfg, num_pages=e["num_pages"],
                       page_size=e["page_size"], slots=e["slots"],
                       max_seq=e["max_seq"],
                       prefill_buckets=tuple(e["prefill_buckets"]),
                       admit_width=e["admit_width"],
                       prefix_cache=e["prefix_cache"],
                       seed=W.stream_seed(seed, "engine"))


# -- the window ----------------------------------------------------------

@dataclasses.dataclass
class Rec:
    """One request as the benchmark saw it."""

    req: Req
    submit_t: float
    times: List[float] = dataclasses.field(default_factory=list)
    done_t: Optional[float] = None
    output: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class RunRecord:
    """What a run measured; the metric readers read it.

    ``steps``: every ``engine.step`` of the window, as (host time at its
    call, at its return, rows it decoded). ``t_prof_on`` and
    ``t_prof_off``: the host times between two steps at which the
    profiler started and stopped (a traced run); the window up to
    ``t_prof_on`` is the clean window, run with no wrap inside a step."""

    cell: Cell
    t_start: float
    t_close: float
    setup_s: float
    peak_bytes: int
    recs: Dict[int, Rec]
    steps: List[Tuple[float, float, int]] = dataclasses.field(
        default_factory=list)
    t_prof_on: Optional[float] = None
    t_prof_off: Optional[float] = None
    rec: Optional[spans.Recorder] = None
    device: Optional[trace.DeviceSummary] = None
    kernel_groups: Dict[str, List[str]] = dataclasses.field(
        default_factory=dict)
    pages_total: int = 0
    pages_peak: Optional[int] = None

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_start

    @property
    def t_clean(self) -> float:
        return self.t_close if self.t_prof_on is None else self.t_prof_on

    @property
    def clean_s(self) -> float:
        """The window up to the profiler's start (all of it in an
        untraced run): what the spans' host times and the served model
        operations of a traced run are read over."""
        return self.t_clean - self.t_start

    def inside(self, t: float) -> bool:
        return self.t_start <= t <= self.t_close

    def token_times(self) -> List[float]:
        return [t for r in self.recs.values() for t in r.times
                if self.inside(t)]

    def gaps_s(self) -> List[float]:
        """Every gap between consecutive tokens of a request, both in the
        window."""
        out = []
        for r in self.recs.values():
            ts = r.times
            out += [b - a for a, b in zip(ts, ts[1:])
                    if self.inside(a) and self.inside(b)]
        return out

    def first_token_s(self) -> List[float]:
        """Submit to first token of every request first answered in the
        window."""
        return [r.times[0] - r.submit_t for r in self.recs.values()
                if r.times and self.inside(r.times[0])]

    def steps_in(self, a: float, b: float) -> List[Tuple[float, float, int]]:
        """The steps called and returned inside ``[a, b]``."""
        return [s for s in self.steps if a <= s[0] and s[1] <= b]

    def decode_lengths(self, a: float, b: float) -> List[int]:
        """The attended length of every decode row whose token came out
        inside ``[a, b]``. The engine emits a token when a decode row
        feeds it (``PagedEngine.step`` commits the row's current token),
        so token ``j`` of a request is the decode row at position
        ``plen + j``, attending ``plen + j + 1`` positions; token 0 came
        from the admission's prefill, and its row makes token 1."""
        return [len(r.req.prompt) + j + 1 for r in self.recs.values()
                for j, t in enumerate(r.times) if a <= t <= b]

    def prompt_tokens(self, a: Optional[float] = None,
                      b: Optional[float] = None) -> int:
        """Prompt tokens of the requests first answered inside ``[a, b]``
        (default: the clean window): the admission runs in the step that
        emits the first token."""
        a = self.t_start if a is None else a
        b = self.t_clean if b is None else b
        return sum(len(r.req.prompt) for r in self.recs.values()
                   if r.times and a <= r.times[0] <= b)

    def model_ops(self) -> float:
        """Model operations served in the clean window: every decode row
        at its length (:meth:`decode_lengths`) and the prefill of each
        prompt first answered then."""
        from .roofline import decode_token_ops, prefill_ops

        d = self.cell.dims
        ops = sum(decode_token_ops(d, n)
                  for n in self.decode_lengths(self.t_start, self.t_clean))
        for r in self.recs.values():
            if r.times and self.t_start <= r.times[0] <= self.t_clean:
                ops += prefill_ops(d, len(r.req.prompt))
        return ops

    def stretch_steps(self) -> List[Tuple[float, float, int]]:
        if self.t_prof_on is None:
            return []
        return self.steps_in(self.t_prof_on, self.t_prof_off)

    def stretch_lengths(self) -> List[List[int]]:
        """The attended lengths of each profiled step's decode rows."""
        return [sorted(self.decode_lengths(t0, t1))
                for t0, t1, _ in self.stretch_steps()]

    def clean_busy_s(self) -> Optional[float]:
        """Device-busy seconds of the clean window, from the profiled
        stretch: its decode device time a step times the clean window's
        steps, plus its admission device time a prompt token times the
        clean window's prompt tokens. The profiler slows the host's side
        of a step and not the device's, so the stretch's own idle share
        reads high; this reading leans on the stretch and the clean
        window serving the same mix, which a closed loop in its steady
        state does. None without a stretch that decoded, or with prompt
        tokens admitted before it and none inside it."""
        d = self.device
        n_stretch = len(self.stretch_steps())
        if d is None or not n_stretch:
            return None
        dec_s, _ = d.select("engine.step", "decode")
        busy = dec_s / n_stretch * len(self.steps_in(self.t_start,
                                                     self.t_clean))
        pre_s, _ = d.select("engine.step", "prefill")
        p_clean = self.prompt_tokens()
        if p_clean:
            p_stretch = self.prompt_tokens(self.t_prof_on, self.t_prof_off)
            if not p_stretch:
                return None
            busy += pre_s / p_stretch * p_clean
        return busy


def _warm(engine, cell: Cell, seed: int) -> None:
    """Run the admission and decode shapes the traffic uses once: a lone
    admission (one row) and a group of ``admit_width`` rows, each through
    a chunk of the largest and of the smallest prefill bucket, then a few
    decode steps."""
    e = cell.work["engine"]
    plen = max(e["prefill_buckets"]) + min(e["prefill_buckets"])
    rng = np.random.default_rng(W.stream_seed(seed, "warm"))
    for n in (1, e["admit_width"]):
        for _ in range(n):
            engine.submit(rng.integers(0, cell.dims.vocab, plen).tolist(),
                          max_new_tokens=3)
        while engine.has_work():
            engine.step()
    engine.finished.clear()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(cell: Cell, engine, traffic: Traffic, seconds: float,
               device: torch.device, t_process: float,
               rec: Optional[spans.Recorder] = None,
               wraps: Optional[spans.Spans] = None) -> RunRecord:
    """Fill the slots with the first wave, then drive the closed loop for
    ``seconds``. With ``rec``, the spans count until the profiler starts,
    and the profiler covers the stretch the workload file names
    (``trace_start`` of the window in, ``trace_seconds`` long), with the
    ``stretch`` wraps of ``wraps`` in place only while it runs; the pool's
    pages in use are read after every step."""
    recs: Dict[int, Rec] = {}
    done: List = []

    def on_token(r, tok):
        rr = recs[r.uid]
        rr.times.append(time.perf_counter())
        if len(r.output_ids) >= r.max_new_tokens:
            rr.output = list(r.output_ids)
            done.append((r.uid, rr))

    def send(req: Req, t: float) -> None:
        uid = engine.submit(req.prompt, max_new_tokens=req.max_new)
        recs[uid] = Rec(req, t)

    def collect(now: float) -> None:
        # a client takes its answer (the engine lets it go) and sends
        # its next request
        for uid, rr in done:
            rr.done_t = now
            engine.finished.pop(uid, None)
            send(traffic.next(), now)
        done.clear()

    engine.on_token = on_token
    now = time.perf_counter()
    for req in traffic.first_wave():
        send(req, now)
    engine.step()                      # admits every slot: the fill
    collect(time.perf_counter())       # a first-wave length of 1
    sync(device)
    # what set-up left is no longer collected in the window
    gc.collect()
    gc.freeze()

    steps: List[Tuple[float, float, int]] = []
    prof, prof_on, prof_off = None, math.inf, math.inf
    t_on = t_off = None
    pages_total = engine.stats()["pages_total"]
    pages_peak = None
    t_start = time.perf_counter()
    if rec is not None:
        rec.in_window = True
        prof_on = t_start + cell.work["trace_start"] * seconds
        pages_peak = 0
    t_end = t_start + seconds
    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        if prof is None and now >= prof_on:
            rec.in_window = False
            wraps.on("stretch")
            prof = trace.profiler()
            prof.start()
            rec.profiling = True
            t_on = time.perf_counter()
            prof_off = t_on + cell.work["trace_seconds"]
        elif prof is not None and rec.profiling and now >= prof_off:
            t_off = now
            prof.stop()
            rec.profiling = False
            wraps.off("stretch")
        t0 = time.perf_counter()
        rows = engine.step()
        now = time.perf_counter()
        steps.append((t0, now, rows))
        if pages_peak is not None:
            pages_peak = max(pages_peak,
                             pages_total - engine.stats()["pages_free"])
        collect(now)
    t_close = time.perf_counter()
    gc.unfreeze()
    if rec is not None:
        rec.in_window = False
        if prof is not None and rec.profiling:
            t_off = t_close
            prof.stop()
            rec.profiling = False
            wraps.off("stretch")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    for r in engine.active:            # what is still in flight
        if r is not None and r.uid in recs:
            recs[r.uid].output = list(r.output_ids)
    run = RunRecord(cell, t_start, t_close, t_start - t_process, peak, recs,
                    steps, t_on, t_off, rec, pages_total=pages_total,
                    pages_peak=pages_peak)
    if prof is not None:
        run.device = trace.read(prof)
    return run


# -- correctness ---------------------------------------------------------

def sample_requests(run: RunRecord, seed: int) -> List[Rec]:
    """Finished requests to check, drawn from the seed: the longest (most
    positions) first, then others in a seeded order until the sample
    holds ``check.served_tokens`` served tokens or
    ``check.max_requests`` requests."""
    fin = [r for r in run.recs.values() if r.done_t is not None
           and r.done_t <= run.t_close]
    if not fin:
        return []
    chk = run.cell.work["check"]
    fin.sort(key=lambda r: (len(r.req.prompt) + len(r.output),
                            r.req.prompt[:4]))
    rng = np.random.default_rng(W.stream_seed(seed, "sample"))
    order = [fin[-1]] + [fin[i] for i in rng.permutation(len(fin) - 1)]
    out, served = [], 0
    for r in order:
        if served >= chk["served_tokens"] or len(out) >= chk["max_requests"]:
            break
        out.append(r)
        served += len(r.output)
    return out


def logit_gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each chosen token's logit lies below the row's best."""
    return logits.max(dim=-1).values - logits.gather(
        1, tokens[:, None]).squeeze(1)


def reference_check(cell: Cell, seed: int, sample: List[Rec],
                    device: torch.device,
                    act_dtype: Optional[torch.dtype] = None):
    """The reference over each sampled prompt with its served tokens.
    Returns (widest gap of a served token, widest gap of the token the
    reference itself would pick: 0), or with ``act_dtype`` (the control)
    the widest gap of the token the control puts first."""
    q = cell.config["quant"]
    kw = dict(quant_type=q["quant_type"], blocksize=q["blocksize"],
              compress_statistics=q["compress_statistics"],
              sigma=cell.config["weights"]["sigma"])
    seqs = [r.req.prompt + r.output for r in sample]
    starts = [len(r.req.prompt) for r in sample]
    ref = ref_model.forward_logits(cell.dims, seed, device, seqs, starts, **kw)
    served = [torch.as_tensor(r.output, device=device) for r in sample]
    gap = max(float(logit_gaps(l, t).max()) for l, t in zip(ref, served))
    if act_dtype is None:
        return gap, None
    ctl = ref_model.forward_logits(cell.dims, seed, device, seqs, starts,
                                   act_dtype=act_dtype, **kw)
    ctl_gap = max(float(logit_gaps(l, c.argmax(dim=-1)).max())
                  for l, c in zip(ref, ctl))
    return gap, ctl_gap


def _host_probe(reps: int = 5) -> float:
    """Seconds of a fixed piece of Python work, the least of ``reps``: how
    fast this host ran the single thread that paces a host-bound step."""
    best = math.inf
    for _ in range(reps):
        t = time.perf_counter()
        sum(i * i for i in range(200_000))
        best = min(best, time.perf_counter() - t)
    return best


# -- one run -------------------------------------------------------------

def card_facts(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}


def run_cell(bench: Bench, name: str, seed: int, seconds: float,
             traced: bool, device: torch.device, t_process: float,
             control: Optional[torch.dtype] = None):
    """One run: returns (result dict without ``checks``, checks list of
    (name, value, limit, ok), messages). ``control``: also read the
    control (the reference with its projections' inputs in that type)
    on the same sample, as ``result["control_gap"]``; the benchmark's
    runs never do."""
    cell = bench.cell(name)
    msgs: List[str] = []
    phases = {"imports": time.perf_counter() - t_process}
    t = time.perf_counter()

    def phase(key):
        nonlocal t
        sync(device)
        now = time.perf_counter()
        phases[key] = now - t
        t = now

    if device.type == "cuda":
        from quantizations_tpu_torch.ops import cuda as qcuda
        qcuda.build()
    phase("kernels")
    cfg = program_config(cell)
    params = build_program(cell, cfg, seed, device)
    phase("model")
    engine = make_engine(cell, cfg, params, seed)
    rec, wraps = None, None
    if traced:
        rec = spans.Recorder()
        wraps = spans.Spans(rec, bench.dir)
        wraps.on("window")
        if rec.missing:
            msgs.append("span points missing from the program: "
                        + ", ".join(rec.missing))
    try:
        phase("pool")
        _warm(engine, cell, seed)
        if traced:
            # the profiler's first start loads its tracing library: in
            # set-up, not in the window
            with trace.profiler():
                engine.step()
        phase("warm")
        traffic = Traffic(cell.traffic, seed, cell.dims.vocab)
        ru0, cpu0 = resource.getrusage(resource.RUSAGE_SELF), \
            time.process_time()
        run = run_window(cell, engine, traffic, seconds, device, t_process,
                         rec, wraps)
        ru1, cpu1 = resource.getrusage(resource.RUSAGE_SELF), \
            time.process_time()
        phases["fill"] = run.t_start - t
        phases["window"] = run.window_s
        t = run.t_close
    finally:
        if wraps is not None:
            wraps.remove()
    run.kernel_groups = bench.kernel_groups()
    found = banned_modules()
    host_probe = _host_probe()
    # the program's state goes before the reference runs
    engine.on_token = None
    del engine, params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    metrics = {}
    for m in bench.metrics(cell, traced):
        v = bench.reader(m["name"])(run)
        if v is None:
            msgs.append(f"metric {m['name']}: nothing to read")
            continue
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    completed = [r for r in run.recs.values() if r.done_t is not None
                 and run.inside(r.done_t)]
    failed = sum(1 for r in completed if len(r.output) != r.req.max_new)
    sample = sample_requests(run, seed)
    limit = cell.work["check"]["logit_gap_limit"]
    phase("trace_read_and_free")
    gap, ctl_gap = math.inf, None
    if sample:
        gap, ctl_gap = reference_check(cell, seed, sample, device, control)
    phase("reference")
    served = sum(len(r.output) for r in sample)
    checks = [("logit_gap", gap, limit, gap <= limit),
              ("wrong_lengths", failed, 0, failed == 0),
              ("served_checked", served, 1, served >= 1)]
    dev = dict(card_facts(device), memory_peak_bytes=int(run.peak_bytes))
    result = {"correct": all(c[3] for c in checks),
              "attempted": len(completed), "failed": failed,
              "metrics": metrics, "device": dev}
    if traced and run.device is not None:
        d = run.device
        dev["busy_s"] = d.busy_s
        dev["window_s"] = d.window_s
        result["breakdown"] = {"device_ops": d.top_ops,
                               "idle_gaps": d.idle_by_host}
        clean_busy = run.clean_busy_s()
        result["trace"] = {
            "attributed_share": (1.0 - d.device_s.get("", 0.0)
                                 / max(sum(d.device_s.values()), 1e-30)),
            "launch_found": d.launch_found, "link_found": d.link_found,
            "unlinked": d.unlinked, "spans": d.spans,
            "missing": rec.missing,
            "stretch_steps": len(run.stretch_steps()),
            "stretch_idle_pct": (1.0 - d.busy_s / d.window_s) * 100
            if d.window_s else None,
            "stretch_decode_busy_ms_per_step":
            d.select("engine.step", "decode")[0] * 1e3
            / max(len(run.stretch_steps()), 1),
            "clean_steps": len(run.steps_in(run.t_start, run.t_clean)),
            "clean_s": run.clean_s,
            "clean_busy_s": clean_busy}
    gaps = run.gaps_s()
    result["quantiles_ms"] = {
        "itl": [float(np.percentile(gaps, q)) * 1e3 for q in (50, 90, 95, 99)]
        if gaps else [],
        "ttft": [float(np.percentile(run.first_token_s(), q)) * 1e3
                 for q in (50, 90)] if run.first_token_s() else []}
    result["phases_s"] = phases
    result["window"] = {
        "steps": len(run.steps),
        "rows_per_step": (sum(r for _, _, r in run.steps)
                          / max(len(run.steps), 1)),
        "pages_total": run.pages_total, "pages_peak": run.pages_peak,
        # host contention: the process's CPU seconds, its involuntary
        # context switches and the machine's load over the window
        "cpu_s": cpu1 - cpu0,
        "involuntary_switches": ru1.ru_nivcsw - ru0.ru_nivcsw,
        "load1": os.getloadavg()[0],
        "host_probe_ms": host_probe * 1e3,
        # the steps of the stretch before the profiler's start, traced
        # or not: the clean window of a traced run against the same
        # stretch of an untraced one
        "steps_before_trace_start": len(run.steps_in(
            run.t_start, run.t_start + cell.work["trace_start"] * seconds))}
    result["sample"] = [[len(r.req.prompt), len(r.output)] for r in sample]
    if control is not None:
        result["control_gap"] = ctl_gap
    result["banned_modules"] = found
    return result, checks, msgs
