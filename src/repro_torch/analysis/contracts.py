"""Capture, sync and mask contracts (tracecheck layer 2), ported from
``repro.analysis.contracts``: each of the reference's jaxpr / HLO checks
in its torch meaning, on tiny canonical configs.

- **mask** — for every registered mask strategy × task shape,
  ``select_mask`` (and ``select_mask_traced`` where supported) gives a
  (K,) bool mask on the losses' device.  The traced mask also runs with
  no synchronizing op: under a ``TorchDispatchMode`` that refuses
  ``BANNED_SYNC_OPS`` (``.item()``, ``nonzero``, ``unique``,
  ``masked_select``, a bool-mask index, ...) and, on the card, under
  ``torch.cuda.set_sync_debug_mode("error")`` — the reference's "no
  callback primitive in the traced mask".  Both tiers also run on
  ``meta`` tensors (the strategy's own tensors moved there), the
  counterpart of ``jax.eval_shape``, except where ``META_UNSUPPORTED``
  names the op that stops them.
- **donation** — the reference checks that the fused chunk donates its
  carry; here a replay writes into its graph's own buffers: across
  replays of one chunk length every input and output buffer of the
  captured ``_Graph`` keeps its address, and a replayed chunk leaves
  nothing allocated but the params copy it hands out.
- **retrace** — the reference's compile budgets become three budgets,
  each driven across two separate ``rounds()`` calls (``drive_twice``):
  each kernel library (``repro_torch.kernels.build``) is loaded once a
  process; a fused engine captures at most ``FUSED_CHUNK_BUDGET``
  distinct chunk lengths, each once (``RETRACE_BUDGET``), none in the
  second call; and a round (compiled, scaleout) or a chunk (fused) makes
  exactly the host reads its code means to make, counted as
  synchronizing calls under ``set_sync_debug_mode("warn")``, with none
  inside a replay.  The scaleout backend runs on a world of one.

Synchronizing calls, captures and libraries exist on the card only: on
the CPU those contracts raise ``SkipContract`` with the reason, and
``run_contracts("cuda")`` counts a skip as a failure.  Everything here
imports torch lazily: the CLI imports this module only when contracts
run (never ``repro_torch.analysis``'s package ``__init__``).
"""

from __future__ import annotations

import contextlib
import copy
import warnings
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "BANNED_SYNC_OPS",
    "COMPILED_ROUND_READS",
    "ChunkProbe",
    "ContractReport",
    "ContractResult",
    "EVAL_READS",
    "FUSED_CHUNK_BUDGET",
    "FUSED_CHUNK_READS",
    "META_UNSUPPORTED",
    "REPLAY_READS",
    "RETRACE_BUDGET",
    "SCALEOUT_ROUND_READS",
    "SkipContract",
    "TASK_SHAPES",
    "count_syncs",
    "drive_twice",
    "run_contracts",
]

# aten ops that read a device value to the host (the overload packets'
# names): a traced mask must call none of them.
BANNED_SYNC_OPS = (
    "_local_scalar_dense", "is_nonzero", "equal", "nonzero", "_unique", "_unique2",
    "unique_dim", "unique_consecutive", "unique_dim_consecutive", "masked_select",
)

# One capture per chunk length and one load per kernel library a process:
# the budget the reference holds each jitted callable's compiles to.
RETRACE_BUDGET = 1
# Distinct fused chunk lengths with an aligned fuse_rounds/eval_every:
# the round-0 chunk, the steady-state chunk, and the tail.
FUSED_CHUNK_BUDGET = 3

# The host reads each round loop makes on purpose, each one synchronizing
# copy to or from the card (a count under set_sync_debug_mode("warn")):
# CompiledEngine._round_step copies the round's (K,) dispatched mask,
# survivors and arrivals and its (m,) cohort losses to the host;
COMPILED_ROUND_READS = 4
# FusedEngine.rounds copies the chunk's (L, K) masks, survivors and
# arrivals and (L, m) cohort losses, once a chunk;
FUSED_CHUNK_READS = 4
# a replayed chunk (FusedEngine._run_chunk with its graph: the draws, the
# copies into the graph's buffers, the replay, the params copy) reads none;
REPLAY_READS = 0
# ScaleoutEngine, through Engine._round_step's hooks: the polled (K,)
# losses to the host, back to the card for the mask, the mask to the
# host, the trained clients' losses to the host, and in ``aggregate`` the
# weighted indices to the card and the ``True`` its index_put_ writes
# there (a one-element copy);
SCALEOUT_ROUND_READS = 6
# Engine.evaluate, on each evaluated round: the test loss and the accuracy.
EVAL_READS = 2

# The task axis enters mask selection through its canonical shape
# triple: (K clients, cohort m, feature-histogram bins) — classification
# clusters on n_classes-bin label histograms, LM on hist_bins topic
# histograms (the reference's conformance-grid configs).
TASK_SHAPES: dict[str, tuple[int, int, int]] = {
    "classification": (12, 4, 10),
    "lm": (8, 3, 16),
}

# (strategy, tier) pairs whose mask cannot run on meta tensors, with the op
# that stops them.
META_UNSUPPORTED: dict[tuple[str, str], str] = {
    ("fedlecc_adaptive", "compiled"): "_round_J reads the losses to the host (.cpu() "
                                      "of a meta tensor has no data)",
}

# indexing ops whose indices may hold a bool mask (their second argument)
_INDEX_OPS = ("index", "index_put", "index_put_", "_index_put_impl_")
_SYNC_WARNING = "synchronizing CUDA operation"


@dataclass(frozen=True)
class ContractResult:
    """One contract check: ``name`` passed/failed/skipped with detail."""

    name: str
    ok: bool
    detail: str = ""
    skipped: bool = False

    def to_dict(self) -> dict:
        return {
            "name": self.name, "ok": self.ok,
            "skipped": self.skipped, "detail": self.detail,
        }

    def __str__(self) -> str:
        status = "SKIP" if self.skipped else ("ok" if self.ok else "FAIL")
        return f"[{status}] {self.name}" + (f" — {self.detail}" if self.detail else "")


@dataclass
class ContractReport:
    """The results on ``device``; on the card, where every contract can run,
    a skipped one fails the report."""

    device: str = "cpu"
    results: list[ContractResult] = field(default_factory=list)

    def passed(self, r: ContractResult) -> bool:
        return r.ok and not (r.skipped and self.device == "cuda")

    @property
    def ok(self) -> bool:
        return all(self.passed(r) for r in self.results)

    def to_dict(self) -> dict:
        return {"ok": self.ok, "device": self.device,
                "results": [r.to_dict() for r in self.results]}


class SkipContract(Exception):
    """Raised by a check that cannot run in this environment."""


def _run(report: ContractReport, name: str, fn) -> None:
    try:
        detail = fn() or ""
        report.results.append(ContractResult(name, True, detail))
    except SkipContract as e:
        report.results.append(ContractResult(name, True, str(e), skipped=True))
    except Exception as e:  # noqa: BLE001 — a contract check failing IS the signal
        report.results.append(
            ContractResult(name, False, f"{type(e).__name__}: {e}")
        )


def _card_only(device, what: str) -> None:
    if device.type != "cuda":
        raise SkipContract(f"card only: {what}")


# ---------------------------------------------------------------- fixtures
def _planted_histograms(K: int, C: int, G: int = 3, seed: int = 0) -> np.ndarray:
    """Label histograms with G planted modes (same construction as the
    reference's) so OPTICS-based strategies see real density structure."""
    rng = np.random.default_rng(seed)
    modes = rng.dirichlet(np.ones(C) * 0.2, size=G)
    assign = np.arange(K) % G
    return np.stack([rng.dirichlet(modes[g] * 200.0 + 1e-3) for g in assign])


def _strategy(name: str, K: int, m: int, C: int, device):
    from repro_torch.core.strategies import get_strategy

    strat = get_strategy(name, m=m)
    rng = np.random.default_rng(0)
    strat.setup(_planted_histograms(K, C), rng.integers(20, 61, size=K), device=device)
    return strat


def _losses(K: int, device):
    """The contracts' (K,) fp32 loss vector: distinct, increasing."""
    import torch

    return torch.as_tensor(np.linspace(0.1, 2.0, K).astype(np.float32), device=device)


def _noise(strat, K: int, device) -> tuple:
    """``select_mask_traced``'s noise from the engine's draws (round 0)."""
    from repro_torch.engine.draws import TorchDraws

    return TorchDraws(0, device).selection_noise(0, strat.traced_noise, K,
                                                 getattr(strat, "n_clusters", 0))


def _tiny_engine(device, **overrides):
    """A tiny classification engine (12 clients, 16-dim features) — the
    reference's ``_tiny_engine`` config, on ``device``."""
    from repro_torch.data import make_classification
    from repro_torch.engine import FLConfig, make_engine

    cfg_kw = dict(
        n_clients=12, m=4, rounds=4, strategy="fedlecc",
        strategy_kwargs={"J": 3}, hidden=(16,), eval_samples=16,
        eval_every=2, target_hd=0.8, seed=0,
    )
    cohort_gather = overrides.pop("cohort_gather", True)
    cfg_kw.update(overrides)
    cfg = FLConfig(**cfg_kw)
    train = make_classification(240, n_features=16, n_classes=10, seed=0)
    test = make_classification(80, n_features=16, n_classes=10, seed=1)
    return make_engine(cfg, train, test, n_classes=10, device=device,
                       cohort_gather=cohort_gather)


# ---------------------------------------------------------------- sync counting
class _RefuseSyncs:
    """While active: every aten op of ``BANNED_SYNC_OPS`` raises, and on the
    card every synchronizing CUDA call raises too."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode

        class Refuse(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = func.overloadpacket.__name__
                # x[mask] with a bool mask: a nonzero inside the index kernel
                masked = name in _INDEX_OPS and any(
                    isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in args[1])
                if name in BANNED_SYNC_OPS or masked:
                    raise AssertionError(f"synchronizing op aten.{name}"
                                         f"{' with a bool mask' if masked else ''}")
                return func(*args, **(kwargs or {}))

        self._mode = Refuse()
        self._mode.__enter__()
        if self.device.type == "cuda":
            self._prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
        return self

    def __exit__(self, *exc):
        import torch

        if self.device.type == "cuda":
            torch.cuda.set_sync_debug_mode(self._prev)
        self._mode.__exit__(*exc)
        return False


class SyncLog:
    """The synchronizing CUDA calls recorded so far (``count``)."""

    def __init__(self, caught: list):
        self._caught = caught

    @property
    def count(self) -> int:
        return sum(1 for w in self._caught if _SYNC_WARNING in str(w.message))


@contextlib.contextmanager
def count_syncs():
    """A ``SyncLog`` of the synchronizing CUDA calls made while the block
    runs (``torch.cuda.set_sync_debug_mode("warn")``, one warning a call)."""
    import torch

    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield SyncLog(caught)
        finally:
            torch.cuda.set_sync_debug_mode(prev)


def _graph_buffers(g) -> tuple[int, ...]:
    """The addresses of a captured chunk's input and output buffers."""
    bufs = [g.params, g.poll, g.batch, *g.noise, *g.ext.values(), *g.out, g.quant_error]
    return tuple(0 if b is None else b.data_ptr() for b in bufs)


class ChunkProbe:
    """Wraps a fused engine's ``_capture`` and ``_run_chunk`` on the card
    (instance attributes over the methods, removed by ``close``):
    ``captures`` lists the chunk lengths it captures, in order, and
    ``replays`` holds for each replayed chunk its length, its synchronizing
    calls (``count_syncs`` around it, so an enclosing count does not see
    them), whether its graph's buffers kept their addresses, the bytes it
    left requested and the bytes of the params copy it hands out."""

    def __init__(self, engine):
        import torch

        self.engine = engine
        self.captures: list[int] = []
        self.replays: list[dict] = []
        capture, run_chunk = engine._capture, engine._run_chunk

        def requested() -> int:
            return torch.cuda.memory_stats(engine.device)["requested_bytes.all.current"]

        def probe_capture(rnd, length, *args):
            self.captures.append(length)
            return capture(rnd, length, *args)

        def probe_run_chunk(rnd, length):
            g = engine._graphs.get(length)
            if g is None:
                return run_chunk(rnd, length)
            ptrs, before = _graph_buffers(g), requested()
            with count_syncs() as syncs:
                out = run_chunk(rnd, length)
                n = syncs.count
            params = out[0][0]
            self.replays.append({
                "length": length, "syncs": n, "same_buffers": _graph_buffers(g) == ptrs,
                "requested_delta": requested() - before,
                "params_bytes": params.numel() * params.element_size()})
            return out

        engine._capture, engine._run_chunk = probe_capture, probe_run_chunk

    def breaches(self) -> list[dict]:
        """The replays that read the device, moved a buffer of their graph
        or left more than their params copy allocated."""
        return [r for r in self.replays if r["syncs"] != REPLAY_READS or not r["same_buffers"]
                or r["requested_delta"] != r["params_bytes"]]

    def close(self) -> None:
        del self.engine._capture, self.engine._run_chunk


def drive_twice(engine, first: int, second: int, *, reads: int | None = None) -> dict:
    """Drive ``engine`` through two separate ``rounds()`` calls, ``first``
    rounds then ``second``; on the card hold them to the budgets: a fused
    engine captures at most ``FUSED_CHUNK_BUDGET`` lengths, each once, none
    in the second call, and each replay keeps its graph's buffers, reads
    nothing (``REPLAY_READS``) and leaves only its params copy allocated
    (``ChunkProbe``); the second call makes exactly the host reads of its
    rounds (``reads`` a round, default ``COMPILED_ROUND_READS``) or chunks
    (``FUSED_CHUNK_READS`` each, outside their replays) and evaluations
    (``EVAL_READS`` each).  Returns what it counted and each round's
    selection; raises ``AssertionError`` on a breach."""
    cfg = engine.cfg
    on_card = engine.device.type == "cuda"
    probe = ChunkProbe(engine) if on_card and hasattr(engine, "_graphs") else None
    selected = []
    try:
        selected += [r.selected for r in engine.rounds(first)]
        start = engine._round
        n_captures, n_replays = (0, 0) if probe is None else (len(probe.captures),
                                                              len(probe.replays))
        with count_syncs() if on_card else contextlib.nullcontext() as syncs:
            selected += [r.selected for r in engine.rounds(second)]
            n_syncs = syncs.count if on_card else None
    finally:
        if probe is not None:
            probe.close()
    out = {"selected": selected}
    if not on_card:
        return out
    evals = sum(1 for r in range(start, start + second)
                if r % cfg.eval_every == 0 or r == cfg.rounds - 1)
    out |= {"syncs": n_syncs, "evaluations": evals}
    if probe is not None:
        second_chunks = probe.replays[n_replays:]
        out |= {"captured_lengths": probe.captures, "replays": len(probe.replays),
                "replayed_chunks_second_call": len(second_chunks),
                "replay_syncs": [r["syncs"] for r in second_chunks]}
        if len(probe.captures) != len(set(probe.captures)):
            raise AssertionError(f"a chunk length was captured twice: {probe.captures}")
        if len(probe.captures) > FUSED_CHUNK_BUDGET:
            raise AssertionError(f"{len(probe.captures)} chunk lengths captured "
                                 f"(budget {FUSED_CHUNK_BUDGET})")
        if len(probe.captures) != n_captures:
            raise AssertionError(f"the second rounds() call captured "
                                 f"{probe.captures[n_captures:]}")
        if not second_chunks:
            raise AssertionError("the second rounds() call replayed no chunk")
        if probe.breaches():
            raise AssertionError(f"a replay read the device, moved its graph's buffers or "
                                 f"left more than its params copy allocated: "
                                 f"{probe.breaches()}")
        want = FUSED_CHUNK_READS * len(second_chunks) + EVAL_READS * evals
    else:
        want = (COMPILED_ROUND_READS if reads is None else reads) * second + EVAL_READS * evals
    out["expected_syncs"] = want
    if n_syncs != want:
        raise AssertionError(f"{n_syncs} synchronizing calls in {second} rounds; the "
                             f"code's own reads are {want} ({out})")
    return out


# ---------------------------------------------------------------- checks
def _assert_mask(mask, K: int, device, what: str) -> None:
    import torch

    if not isinstance(mask, torch.Tensor):
        raise AssertionError(f"{what}: returned {type(mask).__name__}, not a tensor")
    if tuple(mask.shape) != (K,):
        raise AssertionError(f"{what}: mask shape {tuple(mask.shape)} != ({K},)")
    if mask.dtype != torch.bool:
        raise AssertionError(f"{what}: mask dtype {mask.dtype} != torch.bool")
    if mask.device != device:
        raise AssertionError(f"{what}: mask on {mask.device}, the losses on {device}")


def _on_meta(strat):
    """A copy of ``strat`` whose tensors are on ``meta``."""
    import torch

    clone = copy.copy(strat)
    for k, v in vars(strat).items():
        if isinstance(v, torch.Tensor):
            setattr(clone, k, v.to("meta"))
    clone.device = torch.device("meta")
    return clone


def _meta_check(name: str, tier: str, strat, K: int, fn) -> str:
    """``fn(strategy, losses)`` on ``meta``: a (K,) bool mask, or, for a
    ``META_UNSUPPORTED`` pair, the failure it names."""
    import torch

    meta = torch.device("meta")
    try:
        mask = fn(_on_meta(strat), _losses(K, "cpu").to(meta))
    except (NotImplementedError, RuntimeError) as e:
        if (name, tier) in META_UNSUPPORTED:
            return f"not on meta ({META_UNSUPPORTED[name, tier]})"
        raise AssertionError(f"fails on meta tensors: {type(e).__name__}: {e}") from e
    if (name, tier) in META_UNSUPPORTED:
        raise AssertionError("runs on meta, but META_UNSUPPORTED lists it")
    _assert_mask(mask, K, meta, f"{name}.{tier} on meta")
    return "on meta too"


def _check_masks(report: ContractReport, device) -> None:
    import torch

    from repro_torch.engine.registry import (
        mask_selection_strategies,
        traced_selection_strategies,
    )

    traced_names = set(traced_selection_strategies())
    for task, (K, m, C) in TASK_SHAPES.items():
        losses = _losses(K, device)
        for name in mask_selection_strategies():
            strat = _strategy(name, K, m, C, device)

            def compiled_check(strat=strat, name=name, K=K, losses=losses):
                mask = strat.select_mask(losses, np.random.default_rng(0))
                _assert_mask(mask, K, losses.device, f"{name}.select_mask")
                meta = _meta_check(name, "compiled", strat, K,
                                   lambda s, l: s.select_mask(l, np.random.default_rng(0)))
                return f"({K},) bool on {losses.device}; {meta}"

            _run(report, f"mask/{task}/{name}/compiled", compiled_check)

            if name in traced_names:
                def traced_check(strat=strat, name=name, K=K, losses=losses):
                    noise = _noise(strat, K, losses.device)
                    with _RefuseSyncs(losses.device):
                        mask = strat.select_mask_traced(losses, noise)
                    if losses.device.type == "cuda":
                        torch.cuda.synchronize(losses.device)
                    _assert_mask(mask, K, losses.device, f"{name}.select_mask_traced")
                    meta = _meta_check(
                        name, "traced", strat, K,
                        lambda s, l: s.select_mask_traced(
                            l, tuple(t.to("meta") for t in noise)))
                    return (f"({K},) bool on {losses.device}, no synchronizing op"
                            f"{' (sync debug mode: error)' if losses.device.type == 'cuda' else ''}"
                            f"; {meta}")

                _run(report, f"mask/{task}/{name}/traced", traced_check)


def _check_donation(report: ContractReport, device) -> None:
    def donation() -> str:
        _card_only(device, "a CUDA graph's buffers exist on the card; on the CPU every "
                           "chunk runs eagerly")
        eng = _tiny_engine(device, backend="compiled", fuse_rounds=2)
        try:
            probe = ChunkProbe(eng)
            try:
                for _ in eng.rounds(4):
                    pass
                for _ in eng.rounds(2):
                    pass
            finally:
                probe.close()
            if len(probe.replays) < 2:
                raise AssertionError(f"{len(probe.replays)} replays; the check needs two")
            if probe.breaches():
                raise AssertionError(f"a replay read the device, moved its graph's buffers "
                                     f"or left more than its params copy allocated: "
                                     f"{probe.breaches()}")
            return (f"{len(probe.replays)} replays of lengths "
                    f"{sorted({r['length'] for r in probe.replays})}: every buffer kept its "
                    f"address, {probe.replays[0]['params_bytes']} B (the params copy) left "
                    f"allocated each")
        finally:
            eng.close()

    _run(report, "donation/fused-chunk-carry", donation)


def _mapped_libraries() -> dict[str, set[str]]:
    """Kernel libraries mapped into this process, by source name."""
    from repro_torch.kernels import build

    maps: dict[str, set[str]] = {}
    with open("/proc/self/maps") as f:
        for line in f:
            path = line.split()[-1]
            for name in build.SOURCES:
                if path.startswith(str(build.BUILD_DIR)) and f"/lib{name}-" in path:
                    maps.setdefault(name, set()).add(path)
    return maps


def _check_retrace(report: ContractReport, device) -> None:
    def library_loads() -> str:
        _card_only(device, "on the CPU the wrappers run their plain versions and load no "
                           "library")
        from repro_torch.kernels import build

        before = dict(build._loaded)
        for backend in ({"backend": "compiled"}, {"backend": "compiled", "fuse_rounds": 2}):
            eng = _tiny_engine(device, **backend)
            drive_twice(eng, 2, 2)
            if hasattr(eng, "close"):
                eng.close()
        reloaded = [n for n, lib in before.items() if build._loaded[n] is not lib]
        mapped = _mapped_libraries()
        twice = {n: sorted(p) for n, p in mapped.items() if len(p) > RETRACE_BUDGET}
        needed = {"fedavg_reduce", "hellinger_strip"} - set(build._loaded)
        if reloaded or twice or needed:
            raise AssertionError(f"reloaded {reloaded}; mapped more than once {twice}; "
                                 f"never loaded {sorted(needed)}")
        return f"{sorted(build._loaded)} each loaded once (the process maps one file each)"

    def compiled_syncs() -> str:
        _card_only(device, "synchronizing calls are the card's; the CPU has none to count")
        out = drive_twice(_tiny_engine(device, backend="compiled"), 2, 2)
        return f"{out['syncs']} synchronizing calls in 2 rounds, as the code's reads"

    fused_run: dict = {}

    def fused() -> dict:
        if not fused_run:
            eng = _tiny_engine(device, backend="compiled", fuse_rounds=2)
            try:
                # 4 rounds in one call capture the round-0 length-1 chunk and
                # the steady-state length-2 chunk; the second call only replays
                fused_run.update(drive_twice(eng, 4, 2))
            finally:
                eng.close()
        return fused_run

    def fused_captures() -> str:
        _card_only(device, "on the CPU every chunk runs eagerly; nothing is captured")
        out = fused()
        return (f"lengths {out['captured_lengths']} captured once each (budget "
                f"{FUSED_CHUNK_BUDGET}), none in the second call")

    def fused_syncs() -> str:
        _card_only(device, "synchronizing calls are the card's; the CPU has none to count")
        out = fused()
        return (f"{out['syncs']} synchronizing calls in the second call, as the code's reads; "
                f"replays {out['replay_syncs']}")

    def scaleout() -> str:
        # a world of one (no process group): the engine holds every pod
        eng = _tiny_engine(device, backend="scaleout")
        out = drive_twice(eng, 2, 2, reads=SCALEOUT_ROUND_READS)
        ref = _tiny_engine(device, backend="compiled", cohort_gather=False)
        want = [r.selected for r in ref.rounds(4)]
        if out["selected"] != want:
            raise AssertionError(f"scaleout selected {out['selected']}, compiled {want}")
        diff = float((eng.params - ref.params).abs().max())
        if not diff <= 1e-5:
            raise AssertionError(f"scaleout params differ from compiled by {diff}")
        syncs = (f"; {out['syncs']} synchronizing calls in the second call, as the code's "
                 f"reads" if "syncs" in out else "")
        return (f"a world of one, {eng.n_pods} pod(s): 2 + 2 rounds select as compiled "
                f"(cohort_gather=False), params within {diff:.3g}{syncs}")

    _run(report, "retrace/library-loads", library_loads)
    _run(report, "retrace/compiled-syncs", compiled_syncs)
    _run(report, "retrace/fused-captures", fused_captures)
    _run(report, "retrace/fused-syncs", fused_syncs)
    _run(report, "retrace/scaleout", scaleout)


def run_contracts(device="cuda") -> ContractReport:
    """Run every contract check on ``device`` (default the card; raises
    without one); never raises otherwise — failures land in the report
    (the CLI turns them into a non-zero exit)."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    report = ContractReport(device=dev.type)
    _check_masks(report, dev)
    _check_donation(report, dev)
    _check_retrace(report, dev)
    return report
