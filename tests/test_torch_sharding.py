"""The port's sharding policy (``repro_torch.launch.sharding``) against
the reference's (``repro.launch.sharding``): the same spec entries, the
same divisibility fallbacks.

  * the reference's own policy cases, on a stub (16,16) mesh;
  * every leaf of the param tree (train and serve) and of the decode
    cache of the tiny variant of every architecture, on stub (16,16)
    and (2,16,16) meshes: the port's spec tuple equals the reference's
    ``PartitionSpec`` and the fallback records agree;
  * spec tuples map to DTensor placements;
  * the roofline report's bottleneck and compute term (the H100's
    peak).
"""
import jax
import pytest
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as jax_get_config
from repro.configs import get_shape as jax_get_shape
from repro.configs import tiny_variant as jax_tiny_variant
from repro.launch import sharding as JS
from repro.launch.steps import build_model_for as jax_build_model_for
from repro.launch.steps import cache_specs as jax_cache_specs
from repro.launch.steps import params_specs as jax_params_specs

from repro_torch.analysis.roofline import PEAK_FLOPS, RooflineReport
from repro_torch.configs import get_config, get_shape, tiny_variant
from repro_torch.launch import sharding as S
from repro_torch.launch import steps
from repro_torch.launch.sharding import (cache_spec, engine_batch_spec,
                                         fit_spec, param_spec, placements,
                                         pool_spec)
from repro_torch.models.model import tree_leaves, tree_map_with_path


class StubMesh:
    """A ``DeviceMesh``'s names and shape, no process group."""

    def __init__(self, shape, names):
        self.shape = shape
        self.mesh_dim_names = names


class JaxStubMesh:
    """The reference tests' stub: ``.shape`` by name, ``.axis_names``."""

    def __init__(self, mesh):
        self.shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        self.axis_names = mesh.mesh_dim_names


MESH = StubMesh((16, 16), ("data", "model"))
MESH3 = StubMesh((2, 16, 16), ("pod", "data", "model"))
ARCHS = ["deepseek-moe-16b", "zamba2-7b", "hubert-xlarge", "phi3-mini-3.8b",
         "qwen2-vl-7b", "llama3.2-1b", "mixtral-8x7b", "qwen3-14b",
         "rwkv6-7b", "yi-6b", "mamba2-370m"]


# ---------------------------------------------------------------------------
# The reference's policy cases
# ---------------------------------------------------------------------------

def test_attention_weights_fsdp_tp():
    assert param_spec(MESH, "groups/0/attn/wq", (32, 4096, 4096),
                      train=True) == (None, "data", "model")
    assert param_spec(MESH, "groups/0/attn/wo", (32, 4096, 4096),
                      train=True) == (None, "model", "data")


def test_serve_mode_drops_data_axis():
    assert param_spec(MESH, "groups/0/attn/wq", (32, 4096, 4096),
                      train=False) == (None, None, "model")


@pytest.mark.parametrize("shape,want", [
    ((28, 64, 2048, 1408), (None, "model", "data", None)),   # deepseek
    ((32, 8, 4096, 14336), (None, None, "data", "model"))])  # mixtral
def test_moe_expert_sharding(shape, want):
    assert param_spec(MESH, "groups/0/moe/w_up", shape, train=True) == want


def test_vocab_fallback_and_norms():
    assert param_spec(MESH, "embed", (504, 1280), train=True) \
        == (None, "data")
    assert param_spec(MESH, "groups/0/ln1", (32, 4096), train=True) \
        == (None, None)
    assert param_spec(MESH, "ln_f", (4096,), train=True) == (None,)


def test_fit_spec_drops_and_records():
    assert fit_spec(MESH, (32, 32), ("data", "model")) == ("data", "model")
    rec = []
    assert fit_spec(MESH, (100, 64), ("data", "model"), record=rec,
                    path="x/w") == (None, "model")
    (fb,) = rec
    assert (fb.path, fb.dim_index, fb.dim, fb.axis, fb.axis_size) \
        == ("x/w", 0, 100, "data", 16)


def test_param_spec_records_train_fallback_not_serve_drop():
    rec = []
    param_spec(MESH, "embed", (504, 1280), train=True, record=rec)
    (fb,) = rec
    assert fb.path == "embed" and fb.axis == "model" and fb.dim == 504
    rec = []
    param_spec(MESH, "groups/0/attn/wq", (32, 4096, 4096), train=False,
               record=rec)
    assert rec == []


def test_cache_spec_kv_seq_on_model_and_fallback():
    assert cache_spec(MESH, "groups/0/k", (16, 128, 32768, 8, 64)) \
        == (None, "data", "model", None, None)
    rec = []
    assert cache_spec(MESH, "groups/0/k", (13, 1, 4096, 32, 112),
                      record=rec) == (None, None, "model", None, None)
    (fb,) = rec
    assert fb.axis == "data" and fb.dim == 1 and fb.axis_size == 16
    assert cache_spec(MESH, "groups/0/S", (32, 128, 64, 64, 64)) \
        == (None, "data", "model", None, None)


def test_pool_and_engine_batch_specs():
    rec = []
    assert pool_spec(MESH, (2, 2048, 8, 4, 64), record=rec) \
        == (None, "model", None, None, None)
    assert rec == []
    assert pool_spec(MESH, (2, 100, 8, 4, 64), record=rec) == (None,) * 5
    assert rec[0].path == "pool/kv" and rec[0].dim == 100
    rec = []
    assert engine_batch_spec(MESH, (32,), record=rec) == ("data",)
    assert engine_batch_spec(MESH, (32, 16), record=rec) == ("data", None)
    assert rec == []
    assert engine_batch_spec(MESH, (1, 64), record=rec) == (None, None)
    assert rec[0].path == "engine/batch" and rec[0].dim == 1
    assert engine_batch_spec(MESH3, (64, 3)) == (("pod", "data"), None)


def test_placements_of_specs():
    assert placements(MESH, (None, "data", "model")) == (Shard(1), Shard(2))
    assert placements(MESH, (None, "model", None)) == (Replicate(), Shard(1))
    assert placements(MESH3, (("pod", "data"), None)) \
        == (Shard(0), Shard(0), Replicate())
    assert placements(MESH3, ()) == (Replicate(),) * 3
    sh = S.NamedSharding(MESH, (None, "data", "model"))
    assert sh.local_shape((4, 32, 64)) == (4, 2, 4)


# ---------------------------------------------------------------------------
# Every leaf of every tiny architecture, against the reference
# ---------------------------------------------------------------------------

def _jax_paths(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out[JS._path_str(path)] = leaf.shape
    return out


def _records(rec):
    return [(r.path, r.dim_index, r.dim, r.axis, r.axis_size) for r in rec]


@pytest.mark.parametrize("mesh", [MESH, MESH3], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_policy_equals_reference_on_every_leaf(arch, mesh):
    jmesh = JaxStubMesh(mesh)
    cfg = tiny_variant(get_config(arch))
    jcfg = jax_tiny_variant(jax_get_config(arch))
    shape = get_shape("decode_32k")
    model = steps.build_model_for(cfg, shape, device="cpu")
    jmodel = jax_build_model_for(jcfg, jax_get_shape("decode_32k"))
    for train in (True, False):
        ours = {}
        rec = []
        tree_map_with_path(lambda p, s: ours.__setitem__(
            p, (param_spec(mesh, p, s.shape, train=train, record=rec),
                s.shape)),
            steps.params_specs(model, serve=not train))
        theirs = _jax_paths(jax_params_specs(jmodel, serve=not train))
        assert sorted(ours) == sorted(theirs)
        jrec = []
        for path, shp in theirs.items():
            assert ours[path][1] == tuple(shp), path
            assert ours[path][0] == tuple(JS.param_spec(
                jmesh, path, shp, train=train, record=jrec)), (path, train)
        assert sorted(_records(rec)) == sorted(_records(jrec))
    if not cfg.supports_decode:
        return
    small = type(shape)("small", 64, 32, "decode")
    jsmall = type(jax_get_shape("decode_32k"))("small", 64, 32, "decode")
    ours = {}
    rec = []
    tree_map_with_path(lambda p, s: ours.__setitem__(
        p, cache_spec(mesh, p, s.shape, record=rec)),
        steps.cache_specs(model, small))
    jrec = []
    theirs = _jax_paths(jax_cache_specs(jmodel, jsmall))
    assert sorted(ours) == sorted(theirs)
    for path, shp in theirs.items():
        assert ours[path] == tuple(JS.cache_spec(jmesh, path, shp,
                                                 record=jrec)), path
    assert sorted(_records(rec)) == sorted(_records(jrec))


def test_batch_and_opt_shardings_mirror_the_reference():
    cfg = tiny_variant(get_config("qwen2-vl-7b"))
    specs = steps.input_specs(cfg, get_shape("train_4k"))
    got = S.batch_shardings(MESH3, specs, kind="train")
    assert got["positions"].spec == (None, ("pod", "data"), None)
    assert got["tokens"].spec == (("pod", "data"), None)
    model = steps.build_model_for(cfg, get_shape("train_4k"), device="cpu")
    ps = steps.params_specs(model, serve=False)
    opt = {"m": ps, "v": ps, "step": steps.Spec((), ps["embed"].dtype)}
    osh = S.opt_shardings(MESH, opt)
    psh = S.param_shardings(MESH, ps, train=True)
    assert [s.spec for s in tree_leaves(osh["m"])] \
        == [s.spec for s in tree_leaves(psh)]
    assert osh["step"].spec == ()


# ---------------------------------------------------------------------------
# Roofline report
# ---------------------------------------------------------------------------

def test_roofline_report_bottleneck():
    rep = RooflineReport(
        arch="x", shape="y", mesh="m", chips=256,
        flops=1e12, bytes_hbm=1e9, bytes_collective=1e6,
        raw_cost_flops=0, raw_cost_bytes=0,
        mem_argument_bytes=0, mem_temp_bytes=0, mem_output_bytes=0,
        model_flops=1e14).finalize()
    assert rep.compute_s == pytest.approx(1e12 / PEAK_FLOPS)
    assert PEAK_FLOPS == 989e12
    assert rep.bottleneck == "compute"
    assert rep.useful_flops_ratio == pytest.approx(1e14 / (1e12 * 256))
    assert set(rep.to_dict()) >= {"bottleneck", "useful_flops_ratio",
                                  "compute_s", "memory_s", "collective_s"}
