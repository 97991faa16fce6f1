"""Production-mesh dry run: run every (architecture x input shape) step
once on a fake process group and record memory, cost and roofline
(port of ``repro.launch.dryrun``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape decode_32k [--multi-pod] [--out experiments/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The reference lowers and compiles each step on 256 / 512 placeholder
devices.  The port runs it on a fake process group of 512 ranks
(``FakeStore``): a (16,16) or (2,16,16) ``DeviceMesh``; params,
optimizer state, batch and cache are DTensors placed by
``launch.sharding`` over fake tensors (``FakeTensorMode``), so nothing
is allocated and every collective returns at once.  A dispatch mode
counts, per device, what the step's local operations do:

  * FLOPs of every matrix product (2 * numel(out) * K), and the bytes of
    their operands and results (the reference's ``dot_bytes``);
  * the result bytes of every collective over more than one rank;
  * live bytes of the rank's tensors, sampled at every operation: the
    peak;
  * ``torch.utils.flop_counter``'s FLOPs and every operation's operand
    and result bytes, beside them (the reference's raw cost analysis).

DTensor's sharding propagation runs each operation once more on global
shapes to derive output metadata; those runs are not counted.  Blocks
without a DTensor sharding strategy run per rank inside ``local_map``
(attention, the expert-parallel MoE); a step that still fails writes
the reference's ``fail`` record, naming the operator.

This is the proof that the distribution config is coherent: a sharding
mismatch or an unsupported collective fails here.  The dry run owns its
process's default process group: run it in a process of its own.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import threading
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves

from ..configs import get_config, get_shape
from ..models import model as MODEL
from ..models import moe as MOE
from ..models.layers import on_mesh
from ..models.model import tree_leaves, tree_map
from ..analysis.roofline import RooflineReport
from .mesh import make_production_mesh
from .sharding import (batch_shardings, cache_shardings, opt_shardings,
                       param_shardings)
from .steps import (Spec, build_decode_step, build_model_for,
                    build_prefill_step, build_train_step, cache_specs,
                    input_specs, params_specs, skip_reason)

ARCHES = [
    "deepseek-moe-16b", "zamba2-7b", "hubert-xlarge", "phi3-mini-3.8b",
    "qwen2-vl-7b", "llama3.2-1b", "mixtral-8x7b", "qwen3-14b",
    "rwkv6-7b", "yi-6b",
]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
WORLD = 512


# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------

def fake_world(world: int = WORLD) -> None:
    """Start the default process group as a fake one of ``world`` ranks
    (rank 0), unless it is one already."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() < world:
            raise RuntimeError(
                "the dry run needs the default process group of its own "
                "process (a fake one of >= 512 ranks); run it in a fresh "
                "process")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


# ---------------------------------------------------------------------------
# Per-device counters
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
_DOTS = {_aten.mm.default: (0, 1), _aten.bmm.default: (0, 1),
         _aten.addmm.default: (1, 2), _aten.baddbmm.default: (1, 2)}
_in_propagation = threading.local()


@contextlib.contextmanager
def _skip_propagation():
    """Mark DTensor's output-metadata runs (global shapes) so the
    counters skip them."""
    from torch.distributed.tensor import _sharding_prop as sp
    cls = sp.ShardingPropagator
    orig = getattr(cls, "_propagate_tensor_meta_non_cached", None)
    if orig is None:
        yield
        return

    def marked(self, *a, **kw):
        _in_propagation.on = True
        try:
            return orig(self, *a, **kw)
        finally:
            _in_propagation.on = False

    cls._propagate_tensor_meta_non_cached = marked
    try:
        yield
    finally:
        cls._propagate_tensor_meta_non_cached = orig


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DeviceCounter(TorchDispatchMode):
    """Counts one rank's local operations under DTensor (see the module
    doc).  DTensor operations pass through (``NotImplemented``), so the
    counter sees the local operations DTensor runs for them."""

    def __init__(self, live_args=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_fns = flop_registry
        self.flops = self.dot_bytes = self.coll_bytes = 0.0
        self.raw_flops = self.raw_bytes = 0.0
        self.n_collectives = 0
        self.live = self.peak = 0
        self._seen = {}
        self.arg_storages = set()
        for t in live_args:
            self.arg_storages.add(self._track(t))
        self.argument_bytes = self.live

    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._seen:
            n = st.nbytes()
            self._seen[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return key

    def _free(self, key) -> None:
        self.live -= self._seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if getattr(_in_propagation, "on", False):
            return out
        outs = [t for t in pytree_leaves(out) if isinstance(t, torch.Tensor)]
        ins = [t for t in pytree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track(t)
        self.raw_bytes += sum(_nbytes(t) for t in ins + outs)
        fn = self._flop_fns.get(func._overloadpacket)
        if fn is not None:
            self.raw_flops += fn(*args, **kwargs, out_val=out)
        if func in _DOTS:
            ia, ib = _DOTS[func]
            a, b = args[ia], args[ib]
            self.flops += 2.0 * out.numel() * a.shape[-1]
            self.dot_bytes += _nbytes(a) + _nbytes(b) + _nbytes(out)
        elif func.namespace in ("_c10d_functional", "c10d") \
                and "wait" not in func.__name__ and _group_size(args) > 1:
            self.n_collectives += 1
            self.coll_bytes += sum(_nbytes(t) for t in outs)
        return out


def _group_size(args) -> int:
    """The size of the process group a functional collective names (its
    last string argument); a one-rank group moves no bytes."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a for a in args if isinstance(a, str)]
    if not names:
        return 2
    try:
        return _resolve_process_group(names[-1]).size()
    except (KeyError, RuntimeError, ValueError):
        return 2


# ---------------------------------------------------------------------------
# Inputs as DTensors
# ---------------------------------------------------------------------------

def _place(spec: Spec, sharding):
    from torch.distributed.tensor import DTensor
    local = torch.empty(sharding.local_shape(spec.shape), dtype=spec.dtype)
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False)


def _placed(specs, shardings):
    it = iter(tree_leaves(shardings))
    return tree_map(lambda s: _place(s, next(it)), specs)


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


@contextlib.contextmanager
def _globals(**kw):
    """Set module globals of ``models.moe`` / ``models.model`` (keys
    ``MOE_x`` / ``MODEL_x``) for the block, restoring them after."""
    mods = {"MOE": MOE, "MODEL": MODEL}
    saved = []
    for k, v in kw.items():
        mod, name = k.split("_", 1)
        saved.append((mods[mod], name, getattr(mods[mod], name)))
        setattr(mods[mod], name, v)
    try:
        yield
    finally:
        for mod, name, v in saved:
            setattr(mod, name, v)


# ---------------------------------------------------------------------------
# One combo
# ---------------------------------------------------------------------------

def lower_combo(arch: str, shape_name: str, *, multi_pod: bool,
                compile_: bool = True, opt: bool = False, cfg=None,
                shape=None, mesh_shape=None) -> dict:
    """Run one (arch x shape) step on the production mesh and return the
    record.  ``compile_=False`` builds the placed inputs and runs the
    step without the counters (status ``lowered``).  ``cfg``, ``shape``
    and ``mesh_shape`` (``(data, model)``, or ``(pod, data, model)``
    with ``multi_pod``) replace the registry's and the production
    mesh's (tests run tiny configs on small meshes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = cfg or get_config(arch)
    shape = shape or get_shape(shape_name)
    mesh_name = ("pod2x16x16" if multi_pod else "pod16x16") \
        if mesh_shape is None else "x".join(map(str, mesh_shape))
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    reason = skip_reason(cfg, shape)
    if reason:
        rec["status"] = "skip"
        rec["reason"] = reason
        return rec

    fake_world()
    if mesh_shape is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    else:
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh(
            "cpu", tuple(mesh_shape), mesh_dim_names=(
                ("pod", "data", "model") if multi_pod else ("data", "model")))
    chips = mesh.size()
    t0 = time.time()
    model = build_model_for(
        cfg, shape, quant_kv=(opt and shape.kind == "decode"
                              and cfg.arch_type != "ssm"), device="cpu")
    dp = ("pod", "data") if multi_pod else ("data",)
    if opt:
        rec["variant"] = "opt"
    n_groups = 1
    for name in dp:
        n_groups *= mesh.size(mesh.mesh_dim_names.index(name))
    settings = dict(MOE_DATA_AXES=dp, MOE_N_GROUPS=n_groups,
                    MOE_MESH=mesh if opt else None,
                    MODEL_ACT_SHARDING=(dp, None, "model"))

    with FakeTensorMode(allow_non_fake_inputs=True), _globals(**settings):
        batch_s = input_specs(cfg, shape)
        batch = _placed(batch_s, batch_shardings(mesh, batch_s,
                                                 kind=shape.kind))
        if shape.kind == "train":
            params_s = params_specs(model, serve=False)
            params = _placed(params_s, param_shardings(mesh, params_s,
                                                       train=True))
            f32 = tree_map(lambda s: Spec(s.shape, torch.float32), params_s)
            opt_s = {"m": f32, "v": f32, "step": Spec((), torch.int32)}
            opt_state = _placed(opt_s, opt_shardings(mesh, opt_s))
            step = build_train_step(model)
            inputs = (params, opt_state, batch)

            def run():
                return step(*inputs)
        elif shape.kind == "prefill":
            params_s = params_specs(model, serve=True, quant_moe=opt)
            params = _placed(params_s, param_shardings(mesh, params_s,
                                                       train=False))
            step = build_prefill_step(model, cache_len=shape.seq_len)
            inputs = (params, batch)

            def run():
                logits, cache = step(*inputs)
                if cache is not None:     # the reference's out_shardings
                    csh = cache_shardings(mesh, cache)
                    it = iter(tree_leaves(csh))
                    cache = tree_map(lambda t: on_mesh(t, mesh).redistribute(
                        mesh, next(it).placements), cache)
                return logits, cache
        else:
            params_s = params_specs(model, serve=True, quant_moe=opt)
            params = _placed(params_s, param_shardings(mesh, params_s,
                                                       train=False))
            cache_s = cache_specs(model, shape)
            cache = _placed(cache_s, cache_shardings(mesh, cache_s))
            step = build_decode_step(model)
            inputs = (params, batch, cache)

            def run():
                return step(*inputs)

        args = [_local(t) for t in tree_leaves(list(inputs))]
        counter = DeviceCounter(args) if compile_ else None
        with implicit_replication(), _skip_propagation(), \
                (counter or contextlib.nullcontext()):
            out = run()
        rec["lower_s"] = round(time.time() - t0, 1)
        if counter is None:
            rec["status"] = "lowered"
            return rec
        outs = [_local(t) for t in tree_leaves(list(out))
                if isinstance(t, torch.Tensor)]
        arg_keys = counter.arg_storages
        out_keys = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                    for t in outs}
        output_bytes = sum(out_keys.values())
        alias_bytes = sum(n for k, n in out_keys.items() if k in arg_keys)

    arg_bytes = counter.argument_bytes
    peak = counter.peak
    rec["memory"] = {
        "argument_bytes": arg_bytes,
        "output_bytes": output_bytes,
        "temp_bytes": max(peak - arg_bytes - output_bytes + alias_bytes, 0),
        "alias_bytes": alias_bytes,
        "peak_bytes_est": peak,
    }
    # analytic useful FLOPs: 6*N_active*D for train, 2*N_active per token
    # (+attention) for serving
    tok = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                else 1)
    if shape.kind == "train":
        model_flops = 6.0 * cfg.active_param_count() * shape.global_batch \
            * shape.seq_len
    else:
        model_flops = cfg.flops_per_token(
            shape.seq_len if shape.kind == "decode" else 0) * tok
        if shape.kind == "prefill":
            model_flops = 2.0 * cfg.active_param_count() * tok
    roof = RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        flops=counter.flops, bytes_hbm=counter.dot_bytes,
        bytes_collective=counter.coll_bytes,
        raw_cost_flops=counter.raw_flops, raw_cost_bytes=counter.raw_bytes,
        mem_argument_bytes=arg_bytes,
        mem_temp_bytes=rec["memory"]["temp_bytes"],
        mem_output_bytes=output_bytes, model_flops=model_flops).finalize()
    rec["roofline"] = roof.to_dict()
    rec["n_collectives"] = counter.n_collectives
    rec["status"] = "ok"
    return rec


def _failed_op(exc: BaseException) -> str:
    """The operator a DTensor failure names, where it names one."""
    text = str(exc)
    for marker in ("propagation failed for ", "Operator "):
        if marker in text:
            return text.split(marker, 1)[1].split("(")[0].split()[0]
    return ""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-compile", action="store_true",
                    help="run the steps without the counters (trace only)")
    ap.add_argument("--opt", action="store_true",
                    help="the expert-parallel MoE path (models/moe.py)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    combos = []
    arches = ARCHES if (args.all or not args.arch) else [args.arch]
    shapes = SHAPES if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for a in arches:
        for s in shapes:
            for mp in meshes:
                combos.append((a, s, mp))

    os.makedirs(args.out, exist_ok=True)
    n_ok = n_skip = n_fail = 0
    for a, s, mp in combos:
        tag = f"{a}__{s}__{'mp' if mp else 'sp'}" + \
            ("__opt" if args.opt else "")
        try:
            rec = lower_combo(a, s, multi_pod=mp,
                              compile_=not args.no_compile, opt=args.opt)
        except Exception as e:  # noqa: BLE001 — record and continue
            rec = {"arch": a, "shape": s, "mesh": mp, "status": "fail",
                   "error": f"{type(e).__name__}: {e}"[:4000],
                   "operator": _failed_op(e),
                   "traceback": traceback.format_exc()[-2000:]}
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1, default=str)
        st = rec["status"]
        n_ok += st in ("ok", "lowered")
        n_skip += st == "skip"
        n_fail += st == "fail"
        extra = ""
        if st in ("ok",):
            m = rec["memory"]["peak_bytes_est"] / 1e9
            bn = rec["roofline"]["bottleneck"]
            extra = f"peak/dev={m:.2f}GB bottleneck={bn} " \
                    f"lower={rec.get('lower_s')}s"
        elif st == "skip":
            extra = rec["reason"]
        elif st == "fail":
            extra = rec["error"][:160]
        print(f"[{st:5s}] {tag}: {extra}", flush=True)
    print(f"done: ok={n_ok} skip={n_skip} fail={n_fail}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
