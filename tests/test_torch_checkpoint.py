"""The port's checkpoint layer against the reference's ``repro.checkpoint``
and its kill-and-resume contract, on the CPU.

- The serializer (the port's own format: magic + JSON header + raw
  little-endian bytes) round-trips tensors and numpy arrays, rejects a
  foreign, truncated or corrupt file with ``CheckpointError`` and a
  mismatch against ``like`` with a plain ``ValueError``.
- ``CheckpointPolicy``, ``Checkpointer``, ``latest_checkpoint``,
  ``checkpoint_paths``, ``JsonlTracker`` and ``read_jsonl`` behave as the
  reference's on the same inputs.
- Kill and resume is bit-identical (params, selections, history, ledger,
  clock) on host, compiled and fused, plain, under the systems axis and
  under both axes (the reference's grid, without scaleout), with int8
  uploads (the quantization generator's state) and under FedDyn; a config
  mismatch and an empty directory are rejected; a corrupt newest file
  falls back to the one before it; fused chunks end at save points.
"""

import json
import os
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from conftest import fl_cfg  # noqa: E402

from repro.checkpoint import policy as ref_policy  # noqa: E402
from repro.checkpoint import tracker as ref_tracker  # noqa: E402
from repro.core.strategies import STRATEGIES as REF_STRATEGIES  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointError,
    Checkpointer,
    CheckpointPolicy,
    JsonlTracker,
    checkpoint_paths,
    latest_checkpoint,
    load_checkpoint,
    load_meta,
    read_jsonl,
    save_checkpoint,
)
from repro_torch.checkpoint.serializer import _MAGIC, tree_structure  # noqa: E402
from repro_torch.checkpoint.tracker import _to_builtin  # noqa: E402
from repro_torch.engine import FLConfig, list_strategies, make_engine  # noqa: E402
from repro_torch.engine.base import RoundResult  # noqa: E402


# ------------------------------------------------------------ serializer


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: one intra-op thread keeps this
    file's many small torch operations from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    return {
        "w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "b": np.ones(3, np.float64),
        "step": np.int32(7),
        "none": None,
        "nested": {"k": np.arange(4, dtype=np.uint32), "flags": torch.tensor([True, False]),
                   "half": torch.linspace(0, 1, 5).to(torch.bfloat16)},
        "groups": [{"a": np.zeros((0, 2), np.float32)}, (torch.tensor(3, dtype=torch.int64),)],
    }


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_serializer_round_trip(tmp_path):
    path = str(tmp_path / "x.ckpt")
    save_checkpoint(path, _tree(), meta={"round": 3, "tag": "t", "nan": float("nan")})
    out, meta = load_checkpoint(path, like=_tree())
    assert meta["round"] == 3 and meta["tag"] == "t" and np.isnan(meta["nan"])
    assert {k: v for k, v in load_meta(path).items() if k != "nan"} == {"round": 3, "tag": "t"}
    assert tree_structure(out) == tree_structure(_tree())
    for a, b in zip(_leaves(out), _leaves(_tree())):
        assert type(a) is (torch.Tensor if isinstance(b, torch.Tensor) else np.ndarray)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))
    assert not os.path.exists(path + ".tmp")  # the atomic rename cleaned up
    with open(path, "rb") as f:
        assert f.read(len(_MAGIC)) == _MAGIC


def test_serializer_loads_onto_a_device_from_a_meta_like(tmp_path):
    """A ``like`` of tensors on the "meta" device allocates nothing; the
    arrays land on ``device`` (the async ledger's skeleton)."""
    path = str(tmp_path / "x.ckpt")
    x = torch.randn(3, 5)
    save_checkpoint(path, {"x": x, "n": np.arange(3)})
    out, _ = load_checkpoint(path, like={"x": torch.empty(3, 5, device="meta"),
                                         "n": np.zeros(3, np.int64)}, device="cpu")
    assert out["x"].device.type == "cpu" and torch.equal(out["x"], x)


def _rewrite_header(path, edit):
    raw = open(path, "rb").read()
    (n,) = struct.unpack("<Q", raw[len(_MAGIC):len(_MAGIC) + 8])
    start = len(_MAGIC) + 8
    header = json.loads(raw[start:start + n])
    edit(header)
    new = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC + struct.pack("<Q", len(new)) + new + raw[start + n:])


def _truncate(path, keep):
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[:keep(len(raw))])


def _garbage(path):
    with open(path, "wb") as f:
        f.write(b"not a checkpoint at all")


def _bad_json(path):
    raw = open(path, "rb").read()
    start = len(_MAGIC) + 8
    with open(path, "wb") as f:
        f.write(raw[:start] + b"{" * 4 + raw[start + 4:])


def _short_payload(h):
    h["leaves"][0]["nbytes"] -= 4


# (how the file is damaged, the ``like`` it is loaded into, the error, its text)
_W = {"w": np.zeros(4, np.float32)}
REJECTIONS = {
    "bad_magic": (_garbage, _W, CheckpointError, "bad magic header"),
    "truncated_prefix": (lambda p: _truncate(p, lambda n: len(_MAGIC) + 3), _W,
                         CheckpointError, "truncated"),
    "truncated_header": (lambda p: _truncate(p, lambda n: len(_MAGIC) + 20), _W,
                         CheckpointError, "truncated"),
    "truncated_payload": (lambda p: _truncate(p, lambda n: n - 2), _W, CheckpointError,
                          "truncated"),
    "unparseable_header": (_bad_json, _W, CheckpointError, "does not parse"),
    "format_version": (lambda p: _rewrite_header(p, lambda h: h.update(version=99)), _W,
                       CheckpointError, "unsupported checkpoint version 99"),
    "payload_length": (lambda p: _rewrite_header(p, _short_payload), _W, CheckpointError,
                       "payload length mismatch at leaf 0"),
    "trailing_bytes": (lambda p: open(p, "ab").write(b"xx"), _W, CheckpointError,
                       "payload length mismatch"),
    "dtype": (None, {"w": np.zeros(4, np.float64)}, ValueError, "dtype mismatch at leaf 0"),
    "tensor_dtype": (None, {"w": torch.zeros(4, dtype=torch.int32)}, ValueError,
                     "dtype mismatch at leaf 0"),
    "shape": (None, {"w": np.zeros((2, 2), np.float32)}, ValueError,
              "shape mismatch at leaf 0"),
    "structure_key": (None, {"other": np.zeros(4, np.float32)}, ValueError,
                      "structure does not match"),
    "structure_list": (None, [np.zeros(4, np.float32)], ValueError,
                       "structure does not match"),
    "structure_none": (None, {"w": np.zeros(4, np.float32), "h": None, "x": [None]},
                       ValueError, "structure does not match"),
}


@pytest.mark.parametrize("case", list(REJECTIONS))
def test_serializer_rejects(tmp_path, case):
    damage, like, err, text = REJECTIONS[case]
    path = str(tmp_path / "x.ckpt")
    save_checkpoint(path, {"w": np.arange(4, dtype=np.float32)})
    if damage is not None:
        damage(path)
    with pytest.raises(err, match=text) as info:
        load_checkpoint(path, like=like)
    # a mismatch against ``like`` is not a fault of the file
    assert isinstance(info.value, CheckpointError) == (err is CheckpointError)


# ---------------------------------------------------------- save policy
def test_policy_matches_reference():
    for kw in ({"every_rounds": 3}, {"every_rounds": 1, "keep_last": 2},
               {"every_rounds": None, "every_seconds": 10.0}, {"every_rounds": 7,
                                                               "every_seconds": 2.5}):
        p, q = CheckpointPolicy(**kw), ref_policy.CheckpointPolicy(**kw)
        assert [p.round_due(r) for r in range(40)] == [q.round_due(r) for r in range(40)]
        for t in (0.0, 2.4, 2.5, 9.9, 10.0, 1e9):
            assert p.time_due(t) == q.time_due(t)
    for kw, text in (({"every_rounds": 0}, "every_rounds"), ({"every_seconds": 0.0},
                     "every_seconds"), ({"keep_last": 0}, "keep_last"),
                     ({"every_rounds": None, "every_seconds": None}, "no trigger")):
        with pytest.raises(ValueError, match=text) as ours:
            CheckpointPolicy(**kw)
        with pytest.raises(ValueError) as theirs:
            ref_policy.CheckpointPolicy(**kw)
        assert str(ours.value) == str(theirs.value)


class _FakeEngine:
    """Just enough surface for ``Checkpointer.save``."""

    def __init__(self):
        self._round = 0
        self.saved = []

    def save(self, path):
        self.saved.append(os.path.basename(path))
        with open(path, "w") as f:
            f.write("x")


def _drive(ck_cls, policy_cls, directory, schedule, **policy):
    """Save decisions and surviving files of one Checkpointer over
    ``schedule`` = [(round, clock)]."""
    t = [0.0]
    ck = ck_cls(directory, policy_cls(**policy), clock=lambda: t[0])
    eng, fired = _FakeEngine(), []
    for rnd, now in schedule:
        t[0] = now
        eng._round = rnd + 1
        fired.append(ck.maybe_save(eng, rnd) is not None)
    return fired, sorted(os.listdir(directory)), eng.saved


@pytest.mark.parametrize("policy", [
    {"every_rounds": None, "every_seconds": 10.0},
    {"every_rounds": 2, "keep_last": 2},
    {"every_rounds": 3, "every_seconds": 4.0, "keep_last": 3},
])
def test_checkpointer_matches_reference(tmp_path, policy):
    schedule = [(r, 1.5 * r) for r in range(12)]
    ours = _drive(Checkpointer, CheckpointPolicy, str(tmp_path / "ours"), schedule, **policy)
    theirs = _drive(ref_policy.Checkpointer, ref_policy.CheckpointPolicy,
                    str(tmp_path / "ref"), schedule, **policy)
    assert ours == theirs
    for ours_fn, ref_fn in ((latest_checkpoint, ref_policy.latest_checkpoint),
                            (checkpoint_paths, ref_policy.checkpoint_paths)):
        got = ours_fn(str(tmp_path / "ours"))
        want = ref_fn(str(tmp_path / "ref"))
        strip = (lambda x: None if x is None else os.path.basename(x))
        assert ([strip(p) for p in got] if isinstance(got, list) else strip(got)) == \
            ([strip(p) for p in want] if isinstance(want, list) else strip(want))


def test_latest_checkpoint_missing_and_empty_dir(tmp_path):
    assert latest_checkpoint(str(tmp_path / "nope")) is None
    assert checkpoint_paths(str(tmp_path / "nope")) == []
    os.makedirs(tmp_path / "empty")
    (tmp_path / "empty" / "round_1.ckpt").write_text("not eight digits")
    assert latest_checkpoint(str(tmp_path / "empty")) is None


# ------------------------------------------------------------- tracker
def test_to_builtin_matches_reference():
    x = {"a": np.float32(1.5), "b": [np.int64(3), (np.arange(3),)], "c": None, "d": "s",
         "e": np.ones((2, 2), np.float32)}
    assert _to_builtin(x) == ref_tracker._to_builtin(x)
    assert _to_builtin(torch.tensor(2.5)) == 2.5 and _to_builtin(torch.arange(3)) == [0, 1, 2]


def test_jsonl_tracker_rows_match_reference(tmp_path):
    """The same RoundResults through both trackers give the same lines; and
    ``read_jsonl`` dedupes a re-logged round the same way."""
    from repro.engine.base import RoundResult as RefRoundResult

    rows = [dict(round=0, selected=(1, 4), mean_selected_loss=0.5, comm_mb=1.25, test_loss=2.0,
                 test_acc=0.25, sim_time=0.5, sim_clock=0.5, n_dropped=1,
                 metrics={"ppl": np.float32(7.5)}, staleness=0.0, params_version=1),
            dict(round=1, selected=(), mean_selected_loss=float("nan"), comm_mb=2.5,
                 staleness=1.5, params_version=1, n_faulty=2, n_quarantined=1)]
    paths = {}
    for name, tracker_cls, result_cls in (("ours", JsonlTracker, RoundResult),
                                          ("ref", ref_tracker.JsonlTracker, RefRoundResult)):
        paths[name] = str(tmp_path / f"{name}.jsonl")
        t = tracker_cls(paths[name])
        for row in rows:
            t.log_round(result_cls(**row))
        t.log_round(result_cls(**{**rows[0], "comm_mb": 123.0}))  # a resumed run re-logs
        t.close()
        t.close()  # idempotent
    assert open(paths["ours"]).read() == open(paths["ref"]).read()
    got = read_jsonl(paths["ours"])
    assert json.dumps(got) == json.dumps(ref_tracker.read_jsonl(paths["ref"]))
    assert [r["round"] for r in got] == [0, 1] and got[0]["comm_mb"] == 123.0


def test_jsonl_tracker_logs_every_round_of_an_engine(tmp_path, data):
    train, test = data
    path = str(tmp_path / "m.jsonl")
    cfg = FLConfig.from_dict(fl_cfg(eval_every=2).to_dict())
    engine = make_engine(cfg, train, test, 10, device="cpu", tracker=JsonlTracker(path))
    list(engine.rounds())
    engine.close_trackers()
    lines = [json.loads(x) for x in open(path)]
    assert [row["round"] for row in lines] == [0, 1, 2]
    assert lines[1]["test_acc"] is None and isinstance(lines[0]["selected"], list)
    assert set(lines[0]) == {f for f in RoundResult.__dataclass_fields__}


# ------------------------------------------------------- strategy state
def test_every_strategy_is_stateless_between_rounds():
    """The reference's default contract, held by every port strategy: an
    empty state dict, and a non-empty one rejected."""
    from repro_torch.engine import STRATEGY_REGISTRY

    assert list_strategies() == sorted(REF_STRATEGIES)
    for name in list_strategies():
        s = STRATEGY_REGISTRY.build(name, m=3)
        assert s.state_dict() == {}
        s.load_state_dict({})
        with pytest.raises(ValueError, match="stateless"):
            s.load_state_dict({"x": np.zeros(1)})


# ---------------------------------------- engine kill-and-resume contract
SYSTEMS = dict(profile="mobile_mix", availability="markov", deadline_s=30.0, over_select=1.3)
FAULTS = {"rate": 0.3, "models": ["sign_flip", "nan_update"], "defense": "validate"}


def _cfg(backend, axes, **kw):
    extra = {}
    if axes in ("systems", "faults"):
        extra["systems"] = SYSTEMS
    if axes == "faults":
        # stale_replay's cache rides the tree; the fused chunk cannot run it
        models = FAULTS["models"] + ([] if backend == "fused" else ["stale_replay"])
        extra["faults"] = {**FAULTS, "models": models}
    if backend == "fused":
        extra |= {"backend": "compiled", "fuse_rounds": 2}
    else:
        extra["backend"] = backend
    return FLConfig.from_dict(fl_cfg(rounds=4, eval_every=2, **extra, **kw).to_dict())


def _assert_history_equal(a, b):
    """Bit-equality with NaN == NaN (an all-dropped round's mean loss)."""
    assert json.dumps(_to_builtin(a), sort_keys=True) == json.dumps(_to_builtin(b),
                                                                    sort_keys=True)


def _kill_and_resume(cfg, data, tmp_path, kill_after=2, every=2):
    train, test = data
    policy = CheckpointPolicy(every_rounds=every, keep_last=3)

    def mk(**kw):
        return make_engine(cfg, train, test, 10, device="cpu", **kw)

    # the reference run has the same save policy: on the fused backend save
    # points shape the chunk pattern
    ref = mk(checkpointer=Checkpointer(str(tmp_path / "ref"), policy))
    ref_results = list(ref.rounds())
    ckdir = str(tmp_path / "ck")
    killed = mk(checkpointer=Checkpointer(ckdir, policy))
    it = killed.rounds()
    pre = [next(it) for _ in range(kill_after)]
    it.close()  # the kill: the run is abandoned after a save
    resumed = mk(resume=ckdir, checkpointer=Checkpointer(ckdir, policy))
    assert resumed._round == kill_after
    post = list(resumed.rounds())
    full = pre + post
    for field in ("round", "selected", "evaluated", "comm_mb", "sim_clock", "n_dropped",
                  "n_faulty", "n_quarantined", "params_version", "staleness"):
        assert [getattr(r, field) for r in full] == [getattr(r, field) for r in ref_results]
    _assert_history_equal(resumed.history, ref.history)
    assert torch.equal(resumed.params, ref.params)
    return ref, resumed


@pytest.mark.parametrize("axes", ["plain", "systems", "faults"])
@pytest.mark.parametrize("backend", ["host", "compiled", "fused"])
def test_kill_and_resume_bit_identical(backend, axes, data, tmp_path):
    ref, resumed = _kill_and_resume(_cfg(backend, axes), data, tmp_path)
    if axes == "faults":
        for name in ("consecutive", "strikes", "quarantined_until", "total_faults"):
            np.testing.assert_array_equal(getattr(resumed._faults.health, name),
                                          getattr(ref._faults.health, name))


def test_kill_and_resume_with_int8_uploads(data, tmp_path):
    """The quantization generator's state and the last quantization error
    ride the checkpoint."""
    ref, resumed = _kill_and_resume(_cfg("compiled", "plain", compress_bits=8), data, tmp_path,
                                    kill_after=1, every=1)
    assert resumed.last_quant_error == ref.last_quant_error


def test_resume_restores_feddyn_server_and_client_state(data, tmp_path):
    train, test = data
    cfg = FLConfig.from_dict(fl_cfg(rounds=4, aggregator="feddyn", client_mode="feddyn",
                                    mu=0.1).to_dict())

    def mk():
        return make_engine(cfg, train, test, 10, device="cpu")

    ref = mk()
    ref.run()
    killed = mk()
    it = killed.rounds()
    next(it), next(it)
    it.close()
    path = str(tmp_path / "fd.ckpt")
    killed.save(path)
    resumed = mk()
    resumed.restore(path)
    _assert_history_equal(resumed.run(), ref.history)
    for name in ("params", "agg_state", "h_clients"):
        assert torch.equal(getattr(resumed, name), getattr(ref, name)), name


def test_restore_rejects_config_mismatch(data, tmp_path):
    train, test = data
    path = str(tmp_path / "x.ckpt")
    make_engine(_cfg("host", "plain"), train, test, 10, device="cpu").save(path)
    other = make_engine(_cfg("host", "plain", m=5), train, test, 10, device="cpu")
    with pytest.raises(ValueError, match=r"config does not match.*'m'"):
        other.restore(path)
    # a structure mismatch is fatal too: a FedDyn engine has more state
    dyn = make_engine(FLConfig.from_dict(fl_cfg(aggregator="feddyn").to_dict()), train, test,
                      10, device="cpu")
    with pytest.raises(ValueError, match="structure does not match"):
        dyn.restore(path)


def test_resume_empty_dir_fails_loudly(data, tmp_path):
    train, test = data
    os.makedirs(tmp_path / "ck")
    with pytest.raises(FileNotFoundError, match="no round_"):
        make_engine(_cfg("host", "plain"), train, test, 10, device="cpu",
                    resume=str(tmp_path / "ck"))


def test_resume_falls_back_past_a_corrupt_newest_file(data, tmp_path):
    train, test = data
    cfg = _cfg("host", "plain")
    ckdir = str(tmp_path / "ck")
    eng = make_engine(cfg, train, test, 10, device="cpu", checkpointer=ckdir)
    list(eng.rounds(3))
    newest = checkpoint_paths(ckdir)[0]
    assert newest.endswith("round_00000003.ckpt")
    _truncate(newest, lambda n: n // 2)
    with pytest.warns(UserWarning, match="skipping corrupt checkpoint"):
        resumed = make_engine(cfg, train, test, 10, device="cpu", resume=ckdir)
    assert resumed._round == 2
    for path in checkpoint_paths(ckdir):
        _garbage(path)
    with pytest.raises(CheckpointError, match="every round_\\*.ckpt file is corrupt"), \
            pytest.warns(UserWarning):
        make_engine(cfg, train, test, 10, device="cpu", resume=ckdir)


def test_fused_chunk_boundaries_align_with_save_points(data, tmp_path):
    """fuse_rounds=4 with a save every 3 rounds: chunks [0] [1, 2] [3, 4, 5]
    (round 0 evaluates), a save at each chunk's end, none inside one."""
    train, test = data
    cfg = FLConfig.from_dict(fl_cfg(backend="compiled", fuse_rounds=4, rounds=6,
                                    eval_every=100).to_dict())
    ckdir = str(tmp_path / "ck")
    engine = make_engine(cfg, train, test, 10, device="cpu",
                         checkpointer=Checkpointer(ckdir, CheckpointPolicy(every_rounds=3)))
    lengths = []
    run_chunk = engine._run_chunk
    engine._run_chunk = lambda rnd, length: (lengths.append(length), run_chunk(rnd, length))[1]
    list(engine.rounds())
    assert lengths == [1, 2, 3]
    assert sorted(os.listdir(ckdir)) == ["round_00000003.ckpt", "round_00000006.ckpt"]
