"""The port's runner side effects against the JAX runner's
(surf_tpu/runner.py:47-58, 119-137, 192-207, 383, 388, 700, 825), on the
CPU:

* the scalar streams: ``Runner.train``, ``Runner.finetune`` and the
  ``Runner.validate`` loop with their steps (and the validate's build,
  mesh and render) replaced by stubs, as tests/test_torch_finetune.py
  drives the finetune loop (no JAX compile), against the port's
  ``Trainer.train``, ``Finetuner.finetune`` and ``Validator.validate``
  with the same stubs: a recording writer in both gives the same ``train``,
  ``train_avg``, ``val_img_avg`` and ``finetune`` (tag, value, step)
  sequences, at a ``log_freq`` that logs some steps and skips others (a
  fake clock makes the validate's timings equal);
* the event file: the port's ``SummaryWriter`` and ``tensorboardX``'s on
  the same calls parse (``tensorboardX.proto.event_pb2``) to the same
  (tag, step, simple_value) records after a ``brain.Event:2`` record,
  every length and data CRC checked with ``tensorboardX``'s CRC-32C;
* ``codes_backup``: one copy, without the ignored names, left alone by a
  second call, an ``OSError`` ignored;
* ``train.debug_nans``: a NaN parameter stops ``Trainer.train`` with
  ``FloatingPointError`` with the key on and not with it off;
* ``train.profile_dir``: a tiny CPU validate through the CLI writes a
  Chrome trace that loads as JSON (and the CLI's code backup and
  ``val_img_avg`` scalars).
"""

import glob
import json
import os
import struct
import types

import numpy as np
import pytest
import torch

from tiny_conf import TINY
from surf_tpu_torch import finetune as t_finetune, train as t_train
from surf_tpu_torch.config import ConfigFactory
from surf_tpu_torch.finetune import Finetuner
from surf_tpu_torch.nn.core import tree_leaves
from surf_tpu_torch.train import Trainer
from surf_tpu_torch.utils import experiment, spans, summary
from surf_tpu_torch.validate import Validator

# one intra-op thread: the suite's xdist workers share the host's cores,
# and a thread a core in every worker oversubscribes them many times over
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TERMS = ("loss", "color_loss", "sparse_loss", "igr_loss", "psnr")


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny steps here run on one thread: beside the other test
    workers, torch's default of a thread a core oversubscribes the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


class Recorder:
    def __init__(self):
        self.calls = []

    def add_scalar(self, tag, value, step):
        self.calls.append((tag, value, step))


def _results(seed):
    """A stub step's loss terms: seeded floats, a new dict each call."""
    rng = np.random.default_rng(seed)
    while True:
        yield {k: float(rng.uniform(0.0, 30.0 if k == "psnr" else 1.0)) for k in TERMS}


class _Clock:
    """``time.time`` (and the spans' ``time.time_ns``) that moves only when
    a stub says so."""

    def __init__(self):
        self.now = 1000.0

    def time(self):
        return self.now

    def time_ns(self):
        return round(self.now * 1e9)


# -- train --------------------------------------------------------------------

N_ITEMS, EPOCHS, TRAIN_LOG_FREQ = 6, 2, 0.5          # logs every 3rd step


class _Loader:
    def __init__(self, n):
        self.n = n

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return self.n

    def __iter__(self):
        return iter([{"x": np.zeros(1, np.float32)} for _ in range(self.n)])


def _jax_train(monkeypatch):
    import jax
    from surf_tpu import runner as jrunner
    monkeypatch.setattr(jrunner.surf, "refresh_match_features", lambda p, s: s)
    results, rec = _results(0), Recorder()
    r = jrunner.Runner.__new__(jrunner.Runner)
    r.start_epoch, r.epochs, r.anneal_end = 0, EPOCHS, 0.0
    r.log_freq, r.save_freq, r.val_freq = TRAIN_LOG_FREQ, 1.0, 10 ** 9
    r.key = jax.random.PRNGKey(0)
    r.params, r.state, r.opt_state = {"implicit_surface": np.zeros(1)}, {}, None
    r.train_loader, r.writer = _Loader(N_ITEMS), rec
    r._dp_setup = lambda: None
    r._train_step_fn = lambda: (lambda p, s, o, batch, k, step_f, anneal:
                                (p, s, o, next(results)))
    r.save = r.validate = lambda epoch: None
    r.train()
    return rec.calls


def _conf(**train):
    conf = ConfigFactory.parse_string(TINY)
    for k, v in train.items():
        conf["train"][k] = v
    return conf


def test_train_streams_equal_the_jax_runner(monkeypatch, tmp_path):
    ref = _jax_train(monkeypatch)
    monkeypatch.setattr(t_train.surf, "refresh_match_features", lambda p, s: s)
    t = Trainer(_conf(), device="cpu", seed=0, base_exp_dir=str(tmp_path))
    assert isinstance(t.writer, summary.SummaryWriter)
    assert t.writer.log_dir == os.path.join(str(tmp_path), "logs")
    results, t.writer = _results(0), Recorder()
    t.dataset = [{"x": np.zeros(1, np.float32)}] * N_ITEMS
    t.epochs, t.log_freq, t.save_freq, t.val_freq = EPOCHS, TRAIN_LOG_FREQ, 1.0, 10 ** 9
    t.step = lambda batch, step_f: next(results)
    t.save = lambda epoch: None
    t.train()
    assert t.writer.calls == ref
    steps = sorted({s for tag, _, s in ref if tag.startswith("train/")})
    assert steps == [0, 3, 6, 9]                          # some steps logged, some not
    assert [(tag, s) for tag, _, s in ref if tag.startswith("train_avg/")] == [
        (f"train_avg/{k}", e) for e in range(EPOCHS) for k in TERMS]


# -- validate -----------------------------------------------------------------

H, W = 4, 5


def _val_items():
    """Two scenes; only the second has a reference depth (so its depth
    terms average over both scenes' count, as ``DictAverageMeter`` does)."""
    rng = np.random.default_rng(7)
    items, outs = [], []
    for i in range(2):
        item = {"rays_o": rng.normal(size=(H * W, 3)).astype(np.float32),
                "color": rng.uniform(size=(H * W, 3)).astype(np.float32),
                "scale_mat": np.eye(4, dtype=np.float32),
                "scene": f"s{i}", "file_name": f"f{i}"}
        if i == 1:
            item["depth_ref"] = rng.uniform(0.5, 2.0, (2 * H, 2 * W)).astype(np.float32)
        items.append(item)
        outs.append((rng.uniform(size=(H, W, 3)), rng.normal(size=(H, W, 3)),
                     rng.uniform(0.0, 2.0, (H, W)), rng.uniform(0.0, 2.0, (H, W))))
    return items, outs


def _mesh_and_render_stubs(clock, outs):
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    tris = np.array([[0, 1, 2]])
    todo = list(outs)

    def mesh(*args, **kwargs):
        clock.now += 2.5
        return verts, tris, None

    def render(*args, **kwargs):
        clock.now += 0.25
        return tuple(a.copy() for a in todo.pop(0))
    return mesh, render


class _JConf:
    def get_bool(self, key, default=None):
        return False if key == "train.dense_render_storage" else default

    def get_string(self, key, default=None):
        return default


def _jax_validate(monkeypatch, tmp_path):
    import jax
    from surf_tpu import runner as jrunner
    items, outs = _val_items()
    clock, rec = _Clock(), Recorder()
    monkeypatch.setattr(jrunner, "time", types.SimpleNamespace(time=clock.time))
    r = jrunner.Runner.__new__(jrunner.Runner)
    r.conf, r.key, r.params, r.state = _JConf(), jax.random.PRNGKey(0), {
        "implicit_surface": None}, None
    r.has_vol, r.mesh_resolution, r.do_clean_mesh = False, 8, False
    r.base_exp_dir, r.val_loader, r.writer = str(tmp_path / "jax"), items, rec
    r._build_volumes_jit = lambda: (lambda p, s, ipts, key: ({}, [("g", "s")], None, ["f"]))
    r.extract_geometry, r.render_full_image = _mesh_and_render_stubs(clock, outs)
    r.validate(epoch=3)
    return rec.calls


def test_validate_stream_equals_the_jax_runner(monkeypatch, tmp_path):
    ref = _jax_validate(monkeypatch, tmp_path)
    items, outs = _val_items()
    clock = _Clock()
    monkeypatch.setattr(spans, "time", types.SimpleNamespace(time_ns=clock.time_ns))
    v = Validator(_conf(), device="cpu", mesh_resolution=8, base_exp_dir=str(tmp_path / "t"))
    assert v.writer.log_dir == os.path.join(str(tmp_path / "t"), "logs")
    v.writer, v.dataset = Recorder(), items
    grid = types.SimpleNamespace(cvalid=torch.ones(3, dtype=torch.bool))
    v.build = lambda ipts: ({}, [(grid, None)], None, ["f"])
    v.extract_geometry, v.render_full_image = _mesh_and_render_stubs(clock, outs)
    results = v.validate(epoch=3)
    assert v.writer.calls == ref
    # in order of first appearance: the depth terms come with the second scene
    assert [tag for tag, _, _ in ref] == [f"val_img_avg/{k}" for k in (
        "psnr", "color_loss", "mesh_seconds", "rays_per_sec", "render_depth_loss",
        "sdf_depth_loss")]
    assert {s for _, _, s in ref} == {3}
    assert dict((tag, x) for tag, x, _ in ref)["val_img_avg/rays_per_sec"] == H * W / 0.25
    assert [m["mesh_s"] for m in results] == [2.5, 2.5]


def test_trainers_validator_writes_into_the_trainers_stream(monkeypatch, tmp_path):
    made = {}

    class _Val:
        def __init__(self, conf, **kwargs):
            made.update(kwargs)

        def validate(self, epoch):
            return []
    monkeypatch.setattr(t_train, "Validator", _Val)
    monkeypatch.setattr(t_train.surf, "refresh_match_features", lambda p, s: s)
    t = Trainer(_conf(), device="cpu", seed=0, base_exp_dir=str(tmp_path))
    results = _results(2)
    t.dataset = [{"x": np.zeros(1, np.float32)}]
    t.epochs, t.val_freq = 1, 1
    t.step = lambda batch, step_f: next(results)
    t.save = lambda epoch: None
    t.train()
    assert made["writer"] is t.writer and made["base_exp_dir"] == t.base_exp_dir


# -- finetune -----------------------------------------------------------------

FT_STEPS, FT_LOG_FREQ = 7, 3                          # logs steps 2 and 5


class _FtData:
    num_views = 3

    def get_random_rays(self, vid, rng):
        return {"view_ids": np.array([vid]), "r": rng.uniform(size=2)}


def _jax_finetune():
    import jax
    from surf_tpu import runner as jrunner
    results, rec = _results(1), Recorder()
    r = jrunner.Runner.__new__(jrunner.Runner)
    r.conf, r.finetune_dataset = _JConf(), _FtData()
    r.host_rng, r.key = np.random.RandomState(0), jax.random.PRNGKey(0)
    r.start_epoch, r.epochs, r.anneal_end = 0, FT_STEPS, 0.0
    r.log_freq, r.save_freq, r.val_freq = FT_LOG_FREQ, 10 ** 9, 10 ** 9
    r.ft_params = r.ft_opt_state = None
    r.writer = rec
    r._finetune_step_fn = lambda: (lambda p, o, batch, key, step_f, anneal:
                                   (p, o, next(results)))
    r.save_finetune = r.validate_finetune = lambda step: None
    r.finetune()
    return rec.calls


def test_finetune_stream_equals_the_jax_runner():
    ref = _jax_finetune()
    results = _results(1)
    f = Finetuner.__new__(Finetuner)
    f.dataset, f.host_rng, f.writer = _FtData(), np.random.RandomState(0), Recorder()
    f.val_before, f.debug_nans, f.epochs = False, False, FT_STEPS
    f.device = torch.device("cpu")
    f.log_freq, f.save_freq, f.val_freq = FT_LOG_FREQ, 10 ** 9, 10 ** 9
    f.step = lambda batch, step: next(results)
    f.save_finetune = f.validate_finetune = lambda step: None
    f.finetune()
    assert f.writer.calls == ref
    assert sorted({s for _, _, s in ref}) == [2, 5]
    assert {tag for tag, _, _ in ref} == {f"finetune/{k}" for k in TERMS}
    assert t_finetune.scalar_writer is summary.scalar_writer


# -- the event file -----------------------------------------------------------

def _records(path):
    from tensorboardX.crc32c import crc32c
    from tensorboardX.proto import event_pb2

    def masked(data):
        c = crc32c(data)
        return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF
    buf, pos, events = open(path, "rb").read(), 0, []
    while pos < len(buf):
        head = buf[pos:pos + 8]
        n, = struct.unpack("<Q", head)
        assert struct.unpack("<I", buf[pos + 8:pos + 12])[0] == masked(head)
        data = buf[pos + 12:pos + 12 + n]
        assert len(data) == n
        assert struct.unpack("<I", buf[pos + 12 + n:pos + 16 + n])[0] == masked(data)
        e = event_pb2.Event()
        e.ParseFromString(data)
        events.append(e)
        pos += 16 + n
    return events


def test_event_file_parses_as_tensorboardx_writes_it(tmp_path):
    tbx = pytest.importorskip("tensorboardX")
    calls = [("train/loss", 0.5, 0), ("train/psnr", 12.25, 3), ("train_avg/loss", 1e-3, 1),
             ("val_img_avg/rays_per_sec", 43116.2, 7), ("finetune/loss", -2.5, 2 ** 40),
             ("finetune/psnr", float("nan"), 5), ("train/big", 1e300, 6)]
    ours = summary.SummaryWriter(str(tmp_path / "ours"))
    assert not os.path.exists(ours.log_dir)               # opened at its first scalar
    theirs = tbx.SummaryWriter(str(tmp_path / "theirs"))
    for tag, value, step in calls:
        ours.add_scalar(tag, value, step)
        theirs.add_scalar(tag, value, step)
    ours.close()
    theirs.close()
    (path,) = glob.glob(str(tmp_path / "ours" / "events.out.tfevents.*"))
    (ref_path,) = glob.glob(str(tmp_path / "theirs" / "events.out.tfevents.*"))
    name = os.path.basename(path).split(".")
    assert name[:3] == ["events", "out", "tfevents"] and name[3].isdigit()
    got, ref = _records(path), _records(ref_path)
    assert got[0].file_version == ref[0].file_version == "brain.Event:2"
    assert got[0].wall_time > 0

    def seq(events):
        return [(e.summary.value[0].tag, e.step, e.summary.value[0].simple_value)
                for e in events[1:]]
    assert len(seq(got)) == len(calls)
    np.testing.assert_equal(seq(got), seq(ref))


def test_other_ranks_and_no_directory_write_nothing(monkeypatch, tmp_path):
    assert isinstance(summary.scalar_writer(None), summary.NullWriter)
    monkeypatch.setattr(summary, "is_main_process", lambda: False)
    w = summary.scalar_writer(str(tmp_path / "logs"))
    assert isinstance(w, summary.NullWriter)
    w.add_scalar("train/loss", 1.0, 0)
    assert not os.path.exists(tmp_path / "logs")


def test_save_scalars_and_means_as_the_jax_tools():
    from surf_tpu.utils.tools import DictAverageMeter, save_scalars as j_save
    rows = [{"a": 1.0, "b": np.float64(2.5), "c": "x", "d": np.float32(1.0)},
            {"a": 4.0, "e": 3}, {"a": 0.5, "b": 1.0, "f": True}]
    meter = DictAverageMeter()
    for r in rows:
        meter.update(r)
    assert summary.mean_scalars(rows) == meter.avg_data
    assert list(summary.mean_scalars(rows)) == list(meter.avg_data)
    got, ref = Recorder(), Recorder()
    summary.save_scalars(got, "m", rows[0], 4)
    j_save(ref, "m", rows[0], 4)
    assert got.calls == ref.calls == [("m/a", 1.0, 4), ("m/b", 2.5, 4)]


# -- codes_backup ---------------------------------------------------------------

def test_codes_backup_copies_once_without_the_ignored_names(tmp_path):
    src = tmp_path / "repo"
    for rel in ("main.py", "pkg/a.py", "pkg/data/d.py", "pkg/__pycache__/a.pyc",
                "pkg/_build/libk.so", "lib.so", "exp/run/x", "outputs/y", ".git/HEAD",
                ".jax_cache/z", "chiprun_out/log", "codes_recording/old", "docs/n.md"):
        p = src / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(rel)
    out = tmp_path / "exp_dir"
    dst = experiment.codes_backup(str(out), src=str(src))
    assert dst == str(out / "codes_recording")
    copied = sorted(os.path.relpath(os.path.join(d, f), dst)
                    for d, _, fs in os.walk(dst) for f in fs)
    assert copied == ["docs/n.md", "main.py", "pkg/a.py"]
    (src / "new.py").write_text("later")
    (src / "main.py").write_text("changed")
    experiment.codes_backup(str(out), src=str(src))
    assert not (out / "codes_recording" / "new.py").exists()
    assert (out / "codes_recording" / "main.py").read_text() == "main.py"
    # best effort: a source that cannot be copied is no error
    experiment.codes_backup(str(tmp_path / "other"), src=str(tmp_path / "missing"))
    assert experiment.ROOT == ROOT


# -- train.debug_nans ---------------------------------------------------------------

@pytest.mark.parametrize("debug_nans", [True, False])
def test_debug_nans_stops_training_at_a_nan(debug_nans, tmp_path):
    t = Trainer(_conf(debug_nans=debug_nans), device="cpu", seed=0,
                base_exp_dir=str(tmp_path))
    t.dataset.metas = t.dataset.metas[:1]
    t.epochs, t.val_freq = 1, 10 ** 9
    t.save = lambda epoch: None
    with torch.no_grad():
        tree_leaves(t.params["implicit_surface"]["color_network"])[0].fill_(float("nan"))
    if debug_nans:
        with pytest.raises(FloatingPointError, match="non-finite"):
            t.train()
        assert not torch.is_anomaly_enabled()             # restored on the way out
    else:
        t.train()                                         # the JAX loop goes on too


# -- train.profile_dir, through the CLI ------------------------------------------

def test_profile_dir_writes_a_chrome_trace(tmp_path):
    from surf_tpu_torch import main
    prof = tmp_path / "prof"
    conf = tmp_path / "tiny.conf"
    conf.write_text(TINY.replace("train {", f'train {{\n    profile_dir = "{prof}"', 1))
    out = tmp_path / "out"
    (m,) = main.main(["--conf", str(conf), "--mode", "val", "--device", "cpu",
                      "--out", str(out), "--mesh_resolution", "16"])
    (trace,) = glob.glob(str(prof / "trace_*.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "mesh" for e in events)   # the validate's phases
    assert os.path.exists(out / "codes_recording" / "surf_tpu_torch" / "main.py")
    (log,) = glob.glob(str(out / "logs" / "events.out.tfevents.*"))
    assert b"val_img_avg/psnr" in open(log, "rb").read()
    assert np.isfinite(m["psnr"])
