"""Port parity of the training demo and its run summary:
``surf_tpu_torch.train_synthetic`` against tools/train_synthetic.py and
``surf_tpu_torch.summarize_run`` against tools/summarize_run.py, on the
CPU at the tiny size (2 stages, a 16^3 base volume, 48x64 images).

* the conf: ``protocol_conf`` equals, key for key, the conf the JAX
  tool's ``main`` builds (captured in-process: the tool loaded by path,
  ``ConfigFactory.parse_string`` wrapped, ``SyntheticDataset`` replaced
  by a stub that stops the run), at the defaults, at the r5 protocol's
  arguments and at 3 stages with ``--n_depth`` and a bf16 matching volume;
* one step from the JAX init carried over by ``convert.from_jax``, on the
  same batch, unperturbed, with the same SDF probe points: every loss
  term (``psnr`` with its 1e-12, ``depth_err`` among them) against the
  JAX tool's formula at rtol 1e-4 / atol 1e-5 (as tests/test_torch_train.py
  holds a step), at steps 0 and 3; the parameters after three Adam steps
  on the same gradients against ``optax.adam`` as the tool builds it,
  flat and with ``--schedule``, at rtol 1e-4 (atol 1e-7, the f32 spacing
  at 1: where an update cancels a parameter to ~1e-6 the two sum it in
  another order);
* the evaluation: the SDF lattice at ``--mesh_res 32`` against the JAX
  tool's ``sdf_chunk`` on its own cascade (rtol 1e-4 / atol 1e-4, as
  tests/test_torch_validate.py holds a lattice), and the Chamfer of the
  port's cleaned vertices equal to the JAX tool's ``chamfer_vs_sphere``'s;
* the summary's stdout equal to the JAX tool's, character for character,
  on the JSONL logs in docs/runs (the JAX r5 runs' and the port's) and on
  generated logs of 0, 1, 2 and 9 rows;
* the CLI on the CPU: 2 steps with an evaluation after each, the JSONL
  rows with the JAX tool's keys, the checkpoint's ``model`` tree with the
  JAX init's keys and shapes; without ``--device`` and without a card it
  exits.  The r5 protocol's model has confs/surf_synthetic_finetune.conf's
  parameter shapes, so its checkpoint feeds ``--mode finetune``; at the
  tiny size the demo's checkpoint takes two finetune steps through
  ``main --mode finetune --resume``.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys
import tempfile

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from surf_tpu.data.synthetic import SyntheticDataset as JDataset
from surf_tpu.losses import compute_loss as j_loss, make_loss_config as j_cfg
from surf_tpu.nn import feature_net as jfn, implicit_surface as jis, sdf_net as jsdf
from surf_tpu.nn import surf as jsurf
from surf_tpu.utils.scheduler import warmup_cosine as j_sched

from surf_tpu_torch import summarize_run, train_synthetic as ts_mod
from surf_tpu_torch.config import ConfigFactory
from surf_tpu_torch.convert import from_jax
from surf_tpu_torch.main import main as tmain
from surf_tpu_torch.losses import make_loss_config as t_cfg
from surf_tpu_torch.nn import surf as tsurf
from surf_tpu_torch.utils import load_checkpoint
from surf_tpu_torch.validate import to_device

# one intra-op thread: the suite's xdist workers share the host's cores,
# and a thread a core in every worker oversubscribes them many times over
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_ARGS = ["--stages", "2", "--base_dim", "16", "--img", "48", "64", "--n_rays", "64"]
CONF_CASES = {"defaults": [], "r5": list(ts_mod.R5_ARGS),
              "stages3": ["--stages", "3", "--n_depth", "128", "--match_dtype", "bfloat16"]}
MESH_RES = 32
# the finetune's validates: at 32^3 the step -1 mesh of the tiny scene
# keeps fewer faces than cleaning's least component (500)
FT_MESH_RES = 40
ADAM_STEPS = 20        # the schedule's length: warmup 2 steps


def _load(name, rel):
    """A module of tools/ loaded by path; it may put paths in front of
    ``sys.path`` (the tools do), which are taken out again."""
    path, env = list(sys.path), os.environ.get("JAX_COMPILATION_CACHE_DIR")
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
        if env is None:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
        else:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = env
    return mod


class _Stop(Exception):
    pass


def _jax_tool_conf(tool, argv):
    """The conf tools/train_synthetic.py's ``main`` builds for ``argv``."""
    import surf_tpu.config as jconfig
    import surf_tpu.data.synthetic as jsyn
    seen, parse = [], jconfig.ConfigFactory.parse_string

    def kept(content):
        seen.append(parse(content))
        return seen[-1]

    def stop(conf, mode):
        raise _Stop
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jconfig.ConfigFactory, "parse_string", staticmethod(kept))
        mp.setattr(jsyn, "SyntheticDataset", stop)
        mp.setattr(sys, "argv", ["train_synthetic.py"] + list(argv))
        mp.setattr(sys, "path", list(sys.path))
        with pytest.raises(_Stop):
            tool.main()
    assert len(seen) == 1
    return seen[0]


def _paths(tree, path=()):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, path + (i,))]
    return [(path, tree)]


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.fixture(scope="module")
def tool():
    return _load("jax_train_synthetic", "tools/train_synthetic.py")


@pytest.fixture(scope="module")
def setup(tool):
    """The JAX tool's conf, init, batch and references at the tiny size
    (each JAX function compiled once), and the port's counterparts."""
    args = ts_mod.parse_args(TINY_ARGS + ["--device", "cpu", "--steps", str(ADAM_STEPS)])
    jconf = _jax_tool_conf(tool, TINY_ARGS + ["--steps", str(ADAM_STEPS)])
    tconf = ts_mod.protocol_conf(args)
    ds = JDataset(jconf["train_dataset"], "train")
    batch = ds[0]
    bj = {k: jnp.asarray(v) for k, v in batch.items() if not isinstance(v, str)}
    params, state, static = jsurf.init(jax.random.PRNGKey(0), jconf["model"])
    static_j = dict(static, remat_stages=False,
                    implicit_surface=dict(static["implicit_surface"], perturb=0.0))
    key = jax.random.PRNGKey(3)
    # the probe points the JAX render draws from this key
    k_core = jax.random.split(jax.random.split(key)[1])[1]
    pts_random = np.asarray(jax.random.uniform(k_core, (1024, 3)) * 2.0 - 1.0)
    cfg = j_cfg(jconf["train.loss"])

    @jax.jit
    def j_terms(p, step_f):
        # tools/train_synthetic.py's loss_fn, unperturbed
        out, _ = jsurf.forward(key, p, state, static_j, "train", bj,
                               cos_anneal_ratio=jnp.minimum(step_f / 10.0, 1.0),
                               step=step_f, perturb=False)
        res = j_loss(cfg, out, bj, step_f, "train")
        res["psnr"] = 20.0 * jnp.log10(1.0 / jnp.sqrt(
            jnp.mean((out["color_fine"] - bj["color"]) ** 2) + 1e-12))
        res["depth_err"] = jnp.abs(out["render_depth"] - bj["depth"]).mean()
        return res

    # the tool's extract_and_eval: the cascade and sdf_chunk
    feats = jax.jit(jfn.apply)(params["feature_network"], bj["imgs"])
    _, stages_j, _, _ = jsurf.build_volumes(
        jax.random.PRNGKey(2), params, state, static, bj, feats, perturb=False,
        training=False, jit_stages=True)

    @jax.jit
    def sdf_chunk(p, stages_ff, pts):
        grids = [g for g, _ in stages_ff]
        m = jis.occupancy_mask(grids, pts)
        s = jsdf.sdf_only(p["sdf_network"], static["implicit_surface"]["sdf"], pts,
                          stages_ff)
        return jnp.where(m[:, None], s, 100.0)[:, 0]

    lin = np.linspace(-1, 1, MESH_RES, dtype=np.float32)
    xs, ys, zs = np.meshgrid(lin, lin, lin, indexing="ij")
    pts_all = np.stack([xs.reshape(-1), ys.reshape(-1), zs.reshape(-1)], -1)
    chunk = 65536
    u_j = np.zeros(MESH_RES ** 3, np.float32)
    for s_ in range(0, len(pts_all), chunk):
        seg = pts_all[s_:s_ + chunk]
        pad = chunk - len(seg)
        if pad:
            seg = np.concatenate([seg, np.zeros((pad, 3), np.float32)])
        vals = np.asarray(sdf_chunk(params["implicit_surface"], stages_j[::-1],
                                    jnp.asarray(seg)))
        u_j[s_:s_ + chunk - pad] = vals[:chunk - pad] if pad else vals

    tp, tstate = from_jax(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state))
    _, _, static_t = tsurf.init(tconf["model"], device="cpu")
    static_t["implicit_surface"] = dict(static_t["implicit_surface"], perturb=0.0)
    return dict(args=args, jconf=jconf, tconf=tconf, ds=ds, batch=batch, params=params,
                state=state, j_terms=j_terms, pts_random=pts_random,
                u_j=u_j.reshape((MESH_RES,) * 3), tp=tp, tstate=tstate, static_t=static_t,
                port={})


def _port_step(setup, step):
    """The port's loss terms at ``step`` and its gradient (once a step)."""
    if step not in setup["port"]:
        copies = {p: t.detach().clone().requires_grad_(True)
                  for p, t in _paths(setup["tp"])}
        tp = _rebuild(setup["tp"], copies)
        res, _ = ts_mod.loss_terms(
            tp, setup["tstate"], setup["static_t"], t_cfg(setup["tconf"]["train.loss"]),
            to_device(setup["batch"], "cpu"), step, None, perturb=False,
            pts_random=torch.from_numpy(setup["pts_random"].copy()))
        res["loss"].backward()
        setup["port"][step] = (res, {p: t.grad.clone() for p, t in copies.items()})
    return setup["port"][step]


def _key(keypath):
    """A JAX key path as the tuple ``_paths`` gives."""
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in keypath)


def _rebuild(tree, leaves, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, leaves, path + (i,)) for i, v in enumerate(tree)]
    return leaves[path]


@pytest.mark.parametrize("case", sorted(CONF_CASES))
def test_protocol_conf_equals_the_jax_tools(tool, case):
    argv = CONF_CASES[case]
    jconf = _jax_tool_conf(tool, argv)
    tconf = ts_mod.protocol_conf(ts_mod.parse_args(argv))
    assert tconf.as_plain_dict() == jconf.as_plain_dict()
    assert ts_mod.TINY.strip() == __import__("tiny_conf").TINY.strip()


def test_parser_defaults_are_the_jax_tools():
    a = ts_mod.parse_args([])
    assert (a.steps, a.base_dim, a.stages, a.img, a.n_rays, a.mesh_res, a.staged,
            a.schedule, a.lr, a.eval_every, a.n_src, a.n_depth, a.match_dtype,
            a.log_jsonl, a.mem_stats, a.save_ckpt, a.device) == (
        100, 32, 2, [96, 128], 512, 128, False, False, 5e-4, 0, 2, 0, None, None, False,
        None, "cuda")
    assert os.path.basename(a.mesh_out) == "synthetic_mesh.ply"


@pytest.mark.parametrize("step", [0, 3])
def test_step_terms_match_the_jax_tool(setup, step):
    ref = setup["j_terms"](setup["params"], jnp.float32(step))
    res, _ = _port_step(setup, step)
    assert set(res) == set(ref)
    for k in ("loss", "color_loss", "psnr", "depth_err", "mfc_loss", "eikonal_loss"):
        assert k in res
    for k in ref:
        got = float(res[k].detach()) if torch.is_tensor(res[k]) else float(res[k])
        np.testing.assert_allclose(got, float(ref[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    assert 0 < float(ref["depth_err"]) and np.isfinite(float(ref["psnr"]))


@pytest.mark.parametrize("schedule", [False, True])
def test_adam_matches_optax_as_the_tool_builds_it(setup, schedule):
    """Three updates on the port's step-3 gradient through the port's
    optimizer and through the JAX tool's optax.adam (its schedule is
    warmup 0.1 -> 1 over two steps here, so each update has its own LR).
    Adam is elementwise, so optax runs on every leaf laid end to end in
    one vector (one array in place of a tree of ~200)."""
    _, grads = _port_step(setup, 3)
    args = ts_mod.parse_args(TINY_ARGS + ["--device", "cpu", "--steps", str(ADAM_STEPS)]
                             + (["--schedule"] if schedule else []))
    tp = _rebuild(setup["tp"], {p: t.detach().clone().requires_grad_(True)
                                for p, t in _paths(setup["tp"])})
    opt, lr_at = ts_mod.make_optimizer(tp, args)
    if schedule:
        scale = j_sched(args.steps, warmup=max(args.steps * 0.1, 1.0))
        j_opt = optax.adam(learning_rate=lambda step: args.lr * scale(step))
    else:
        j_opt = optax.adam(args.lr)
    leaves = _paths(setup["params"])
    flat = lambda arrays: jnp.concatenate([jnp.ravel(a) for a in arrays])
    p_j = flat([x for _, x in leaves])
    g_j = flat([grads[p].numpy() for p, _ in leaves])
    j_state = j_opt.init(p_j)
    for step in range(3):
        upd, j_state = j_opt.update(g_j, j_state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        for path, t in _paths(tp):
            t.grad = grads[path].clone()
        ts_mod.adam_step(opt, lr_at, step)
    got = np.concatenate([_get(tp, p).detach().numpy().ravel() for p, _ in leaves])
    np.testing.assert_allclose(got, np.asarray(p_j), rtol=1e-4, atol=1e-7)
    start = np.concatenate([np.ravel(x) for _, x in leaves])
    assert (got != start).mean() > 0.9
    assert [lr_at(s) for s in range(3)] == pytest.approx(
        [args.lr * (float(scale(s)) if schedule else 1.0) for s in range(3)], rel=1e-6)


def test_eval_lattice_and_chamfer_match_the_jax_tool(setup, tool, monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    tp, tstate, static_t = setup["tp"], setup["tstate"], setup["static_t"]
    tds = ts_mod.SyntheticDataset(setup["tconf"]["train_dataset"], "train")
    stages = ts_mod.build_stages(tp, tstate, static_t, to_device(tds[0], "cpu"))
    u = ts_mod.sdf_lattice(tp["implicit_surface"], static_t["implicit_surface"],
                           stages[::-1], MESH_RES)
    u_j = setup["u_j"]
    assert u.shape == u_j.shape == (MESH_RES,) * 3
    np.testing.assert_array_equal(u == 100.0, u_j == 100.0)
    assert 0 < (u < 100.0).sum() < u.size and (u < 0).any() and (u > 0).any()
    np.testing.assert_allclose(u, u_j, rtol=1e-4, atol=1e-4)
    out = ts_mod.extract_and_eval(tp, tstate, static_t, tds, MESH_RES, "t", "cpu")
    assert out is not None
    verts_c, tris_c, ch = out
    assert len(verts_c) > 0 and len(tris_c) > 0
    np.testing.assert_array_equal(np.load(tmp_path / "synth_eval_verts_t.npy"), verts_c)
    scale_mat = np.asarray(setup["batch"]["scale_mat"])
    assert tool.chamfer_vs_sphere(verts_c, scale_mat, setup["ds"].radius_world)[2] == ch


def _write_log(path, n):
    rng = np.random.RandomState(n)
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({"step": i, "t": round(float(rng.uniform(0.5, 2.0)), 3),
                                "loss": round(float(5 - 0.3 * i + rng.randn()), 5),
                                "color": round(float(rng.uniform()), 5),
                                "psnr": round(float(6 + 0.5 * i + rng.randn()), 3)}) + "\n")
        if n == 2:
            f.write("\n")         # a blank line is skipped


@pytest.mark.parametrize("log", ["train_protocol_r5.jsonl",
                                 "train_protocol_r5_attempt4_100steps.jsonl",
                                 "torch_train_protocol_r16.jsonl",
                                 "rows0", "rows1", "rows2", "rows9"])
def test_summary_prints_what_the_jax_tool_prints(log, tmp_path):
    if log.startswith("rows"):
        path = str(tmp_path / f"{log}.jsonl")
        _write_log(path, int(log[4:]))
    else:
        path = os.path.join(ROOT, "docs", "runs", log)
    jtool = _load("jax_summarize_run", "tools/summarize_run.py")
    outs = []
    for fn in (jtool.main, summarize_run.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn(path)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert outs[1] == "empty log\n" if log == "rows0" else "window-means" in outs[1]


def test_cli_on_the_cpu(setup, tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    log, ckpt = tmp_path / "run.jsonl", tmp_path / "run.ckpt.npz"
    out = ts_mod.main(TINY_ARGS + [
        "--device", "cpu", "--steps", "2", "--eval_every", "1", "--mesh_res", str(MESH_RES),
        "--log_jsonl", str(log), "--save_ckpt", str(ckpt),
        "--mesh_out", str(tmp_path / "mesh.ply")])
    rows = [json.loads(line) for line in open(log)]
    with open(os.path.join(ROOT, "docs", "runs", "train_protocol_r5.jsonl")) as f:
        keys = list(json.loads(f.readline()))
    assert [list(r) for r in rows] == [keys, keys] and [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(v) for r in out["rows"] for v in r.values())
    assert [e[0] for e in out["evals"]] == [1, 2] and all(e[-1] > 0 for e in out["evals"])
    ck = load_checkpoint(str(ckpt))
    assert set(ck) == {"epoch", "model", "state"} and int(ck["epoch"]) == 2
    shapes = jax.eval_shape(lambda k: jsurf.init(k, setup["jconf"]["model"])[:2],
                            jax.random.PRNGKey(0))
    for name, tree in zip(("model", "state"), shapes):
        want = {p: tuple(x.shape) for p, x in _paths(tree)}
        got = {p: tuple(np.shape(x)) for p, x in _paths(ck[name])}
        assert got == want, name
    # the file holds the run's last parameters
    for p, t in _paths(out["params"]):
        np.testing.assert_array_equal(_get(ck["model"], p), t.detach().numpy())
    assert os.path.exists(tmp_path / "mesh.ply")
    assert (tmp_path / "synth_eval_verts_1.npy").exists()


def test_cli_needs_a_card_unless_cpu(monkeypatch):
    assert ts_mod.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        ts_mod.main(TINY_ARGS + ["--steps", "1"])
    with pytest.raises(SystemExit):
        ts_mod.main(TINY_ARGS + ["--steps", "1", "--device", "cpu", "--mem_stats"])


@pytest.mark.parametrize("args,ft_conf", [
    (ts_mod.R5_ARGS, "surf_synthetic_finetune.conf"),
    (ts_mod.MID_ARGS, "surf_synthetic_finetune_mid.conf")], ids=["r5", "mid"])
def test_r5_checkpoint_has_the_finetune_confs_shapes(args, ft_conf):
    """The demo's model at each finetune chain's arguments has its
    finetune conf's parameter and state shapes, so the chain's checkpoint
    resumes there (the mid conf says its model must match the demo's
    ``--stages 3 --base_dim 48`` layout)."""
    conf = ts_mod.protocol_conf(ts_mod.parse_args(args))
    ft = ConfigFactory.parse_file(os.path.join(ROOT, "confs", ft_conf))
    a, sa, _ = tsurf.init(conf["model"], device="cpu")
    b, sb, _ = tsurf.init(ft["model"], device="cpu")
    for x, y in ((a, b), (sa, sb)):
        assert [(p, tuple(t.shape)) for p, t in _paths(x)] == \
            [(p, tuple(t.shape)) for p, t in _paths(y)]


FT_BLOCK = """
finetune_dataset {
    dataset_name = SyntheticDatasetFinetune
    scene = syn0
    ref_view = 0
    num_src_view = 2
    img_hw = [48, 64]
    n_rays = 64
    val_res_level = 8
    n_views_total = 6
}
"""


def test_checkpoint_feeds_the_finetune_cli(monkeypatch, tmp_path):
    """The demo's checkpoint resumes ``main --mode finetune`` as
    scripts/torch_finetune_runs.sh resumes it (stages A to D at the tiny
    size, where the demo's model is the tiny conf's): two finetune steps
    from the demo's parameters (the feature network, which finetune
    leaves as it is, equal to the file's) with the step -1 validate and
    one at the end, and their checkpoint; ``evaluation.synthetic.main``
    scores both meshes in step order; a ``--load_vol`` leg on the conf
    ``derive_conf`` derives as stage C does starts from the saved volumes
    and implicit surface bit for bit, and its mesh is scored too."""
    from surf_tpu_torch import derive_conf, finetune
    from surf_tpu_torch.evaluation import synthetic as ev
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    ckpt = tmp_path / "run.ckpt.npz"
    run = ts_mod.main(TINY_ARGS + ["--device", "cpu", "--steps", "1", "--mesh_res",
                                   str(MESH_RES), "--save_ckpt", str(ckpt),
                                   "--mesh_out", str(tmp_path / "mesh.ply")])
    text = ts_mod.TINY.replace("./exp/tiny", str(tmp_path / "exp")).replace(
        "val_freq = 10", "val_freq = 1000\n    val_before_finetune = true").replace(
        "save_freq = 1", "save_freq = 2")
    assert text != ts_mod.TINY
    conf = tmp_path / "ft.conf"
    conf.write_text(text + FT_BLOCK)
    starts = []
    init_volumes = finetune.Finetuner.init_volumes

    def recorded(self):
        init_volumes(self)
        starts.append(([v.detach().clone() for v in self.vol_state["volumes"]],
                       [t.detach().clone() for _, t in _paths(self.params["implicit_surface"])]))
    monkeypatch.setattr(finetune.Finetuner, "init_volumes", recorded)
    ft = tmain(["--conf", str(conf), "--mode", "finetune", "--resume", str(ckpt),
                "--device", "cpu", "--mesh_resolution", str(FT_MESH_RES),
                "--out", str(tmp_path / "out")])
    last = os.path.join(ft.base_exp_dir, "checkpoints", "model_001.ckpt.npz")
    assert os.path.exists(last)
    for p, t in _paths(run["params"]["feature_network"]):
        torch.testing.assert_close(_get(ft.params["feature_network"], p), t.detach(),
                                   rtol=0, atol=0)
    rows = ev.main([ft.base_exp_dir, "--conf", str(conf)])
    assert [r[0] for r in rows] == [-1, 1]
    assert all(np.isfinite(r[1]) and r[4] > 0 for r in rows)

    derived = tmp_path / "C.conf"
    derive_conf.main([str(conf), str(derived), "train.epochs=1",
                      "train.val_before_finetune=false", "train.val_freq=1",
                      "train.save_freq=1"])
    resumed = tmain(["--conf", str(derived), "--mode", "finetune", "--resume", last,
                     "--load_vol", "--device", "cpu", "--mesh_resolution", str(FT_MESH_RES),
                     "--out", str(tmp_path / "resumed")])
    vols, mlp = starts[1]
    for a, b in zip(vols, ft.vol_state["volumes"]):
        assert torch.equal(a, b.detach())
    for a, (_, b) in zip(mlp, _paths(ft.params["implicit_surface"])):
        assert torch.equal(a, b.detach())
    rows = ev.main([resumed.base_exp_dir, "--conf", str(conf)])
    assert [r[0] for r in rows] == [0] and np.isfinite(rows[0][1]) and rows[0][4] > 0
