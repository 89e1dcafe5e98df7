"""The validate's split across nodes, on 4 gloo ranks on the CPU standing
in for two nodes of two ranks (``LOCAL_WORLD_SIZE=2``, a ``file://``
rendezvous under the test's temporary directory): each node's ranks form
their own ray group (``dist.new_subgroups``), scene i goes to node
i mod 2 (surf_tpu/runner.py:563-566), the node's first rank writes the
artifacts and every rank of a node returns that node's metrics.  Three
scenes of the seeded tiny model, the render unperturbed (a node draws
only its own scenes' jitter, as a JAX process splits its key only for
its own scenes), held against the port's one-process validate bit for
bit at the ranks' CPU thread count."""

import json

import numpy as np
import pytest
import torch

from tiny_conf import TINY
import torch_parallel_workers as workers
from surf_tpu_torch.config import ConfigFactory
from surf_tpu_torch.parallel import distribute
from surf_tpu_torch.validate import TIMINGS, Validator

# one intra-op thread: the suite's xdist workers share the host's cores,
# and a thread a core in every worker oversubscribes them many times over
torch.set_num_threads(1)

RANKS, PER_NODE = 4, 2
SCENES = ["syn0", "syn1", "syn2"]
MESH_RES = 24


def _conf_text():
    text = TINY.replace("perturb = 1.0", "perturb = 0.0").replace(
        "    val_freq = 10\n", "    val_freq = 10\n    val_ray_chunk = 96\n")
    text = text.replace("val_res_level = 4\n    n_scenes = 1",
                        f"val_res_level = 4\n    n_scenes = {len(SCENES)}")
    assert "val_ray_chunk" in text and f"n_scenes = {len(SCENES)}" in text
    return text


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("nodes")
    text = _conf_text()
    # CPU kernels sum in an order that depends on their thread count: the
    # ranks and the one-process validate run with the same count
    threads = torch.get_num_threads()
    share = max(1, threads // RANKS)
    distribute.spawn(workers.node_validate, RANKS,
                     (f"file://{tmp}/rdzv", text, MESH_RES, str(tmp / "ranks"), share),
                     timeout=300, local_world_size=PER_NODE)
    ranks = [json.loads((tmp / "ranks" / f"rank{r}.json").read_text()) for r in range(RANKS)]
    torch.set_num_threads(share)
    try:
        single = Validator(ConfigFactory.parse_string(text), device="cpu",
                           mesh_resolution=MESH_RES,
                           base_exp_dir=str(tmp / "single")).validate()
    finally:
        torch.set_num_threads(threads)
    return dict(ranks=ranks, single=single, out=tmp / "ranks", single_dir=tmp / "single")


def test_ranks_form_a_ray_group_a_node(nodes):
    for r, rec in enumerate(nodes["ranks"]):
        node = r // PER_NODE
        assert rec["local"] == [r % PER_NODE, PER_NODE]
        assert rec["node"] == [node, RANKS // PER_NODE]
        assert rec["group"] == [node * PER_NODE + i for i in range(PER_NODE)]


def test_every_scene_is_validated_once(nodes):
    by_node = {}
    for r, rec in enumerate(nodes["ranks"]):
        scenes = [m["scene"] for m in rec["results"]]
        by_node.setdefault(r // PER_NODE, []).append(scenes)
    for node, per_rank in by_node.items():
        # every rank of a node returns the node's metrics
        assert all(s == per_rank[0] for s in per_rank)
        assert per_rank[0] == SCENES[node::len(by_node)]
    assert sorted(s for per_rank in by_node.values() for s in per_rank[0]) == SCENES


def test_each_node_first_rank_writes_its_artifacts(nodes):
    for r in range(RANKS):
        d = nodes["out"] / f"rank{r}"
        if r % PER_NODE:
            assert not d.exists() or not any(p.is_file() for p in d.rglob("*"))
            continue
        meshes = sorted(p.name for p in (d / "meshes").iterdir())
        assert meshes == [f"{s}_epoch0.ply" for s in sorted(SCENES[r // PER_NODE::2])]


def test_node_results_equal_one_process(nodes):
    single = {m["scene"]: m for m in nodes["single"]}
    for r in range(0, RANKS, PER_NODE):
        for m in nodes["ranks"][r]["results"]:
            ref = single[m["scene"]]
            assert {k: v for k, v in m.items() if k not in TIMINGS} == \
                {k: v for k, v in ref.items() if k not in TIMINGS}
            assert m["mesh_faces"] > 0
        for p in (nodes["out"] / f"rank{r}").rglob("*.npy"):
            q = nodes["single_dir"] / p.relative_to(nodes["out"] / f"rank{r}")
            np.testing.assert_array_equal(np.load(p), np.load(q), err_msg=str(q))
