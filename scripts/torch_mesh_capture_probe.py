"""When does a meshed model's CUDA-graph capture break on one card?

The finding: Python's cyclic garbage collector, when a collection falls
inside a capture, frees an earlier model that only it reaches (a model and
its ForwardGraphs held each other: the dry run's unmeshed SamModel and
EsrganModel, with their CUDA graphs and tensors, per ``saveall``), and that
can break the capture (``cudaErrorStreamCaptureInvalidated`` at the next
cuBLAS product or kernel launch). An early ``import torch._dynamo``
(thousands of objects) and the meshes' DTensors move the collector's
counters so that a collection lands in the dry run's Real-ESRGAN or
BiRefNet capture; without a process group none did. Two repairs in
core/graph.py: ``capture_forward`` collects and keeps the collector off
through the capture, under the capture lock; and a ``ForwardGraphs`` holds
its model's forward by a weak reference, so the cycle is gone and a
dropped model frees its graphs at once. The ``gcon`` token takes out the
first, ``cycle`` the second. With both, a collection inside a capture
frees the earlier model and its graphs again (``saveall`` lists them),
but the capture need not fail: where a collection lands moves with the
process's object counts, and which part of such a release breaks a
capture is not isolated.

Each variant runs in a process of its own, in a one-rank NCCL world made by
``init_distributed`` (a file store), and prints one line: ``ok`` or
``FAILED`` with the error the forward raised inside the capture. A variant
is a name made of tokens joined by ``_``:

  dry        the one-rank dry run's steps (parallel/dryrun.py: SAM3 tp,
             every meshed model built, then the SAM, Real-ESRGAN, BiRefNet
             and server checks); without it, one BiRefNet (SWIN-T, 64^2)
             forward_u8
  loader     a tp-1 mesh hands each model the loader's own tensors (as
             parallel/sharding.py ``mesh_params`` now does itself); views:
             views of them; unmeshed: no mesh (single model only); placed:
             the port as it is
  dynamo     ``import torch._dynamo`` before any model is built; dtensor:
             ``import torch.distributed.tensor``
  watch      every capture under a dispatch mode that reads the capture
             stream's status (cuStreamIsCapturing) around each op and
             names the first op after which it is not active (this mode
             imports torch._dynamo inside the first capture)
  nobcast    the runner's broadcast of the input skipped; settle: the
             card synchronized and 0.5 s waited after it
  sleep / sync / nccl_warm / bir_only / bir_first   (dry) 10 s after the
             build; a synchronize before each check; a collective on every
             group first; only, or first, the BiRefNet check
  nopg       (dry) no process group at all: no init_distributed, every
             model built without a mesh (NCCL and DTensors out), SAM3's tp
             check skipped
  gcoff      Python's garbage collector collected, then off, around each
             warm-up and capture (core/graph.py capture_forward now keeps
             it off through the capture itself)
  gcon       the collector left on inside capture_forward (its state
             before the repair)
  cycle      each ForwardGraphs holds its model's forward strongly again,
             so a model and its graphs make a cycle (the state before the
             repair)
  saveall    (with gcon) gc.DEBUG_SAVEALL through each capture: what a
             collection there finds unreachable is kept, not freed, and its
             types are printed
  threads    print the process's threads (Python's, and the native count)
             at each capture
  cudafirst  the card initialized (torch.cuda.init and one product) before
             ``dynamo``'s import; the import prints what it queued for the
             card's lazy initialization (torch.cuda._queued_calls) either way

    python3 scripts/torch_mesh_capture_probe.py            # DEFAULT_VARIANTS
    python3 scripts/torch_mesh_capture_probe.py V1 V2 ...  # each in a process

Needs one CUDA card; writes each variant's whole output to
chiprun_out/capture_probe_<variant>.log.
"""
import collections
import contextlib
import ctypes
import importlib
import os
import subprocess
import sys
import tempfile
import time
import traceback

DEFAULT_VARIANTS = ("dry_placed", "dry_placed_dynamo", "dry_loader_dynamo", "dry_placed_dynamo_nobcast",
                    "dry_placed_dynamo_settle", "dry_loader_watch", "dry_placed_dynamo_gcon",
                    "dry_placed_dynamo_cycle", "dry_placed_dynamo_gcon_cycle", "dry_placed_dynamo_gcon_cycle_saveall",
                    "dry_nopg_dynamo_gcon_cycle")


def watch_captures(watch: bool, gcoff: bool = False, threads: bool = False, gcon: bool = False,
                   saveall: bool = False, cycle: bool = False) -> None:
    """Wrap core/graph.py's capture_forward: print the error a forward
    raises inside a capture (a failed capture otherwise reports only
    cudaErrorStreamCaptureInvalidated at its end), and with ``watch`` the
    first op after which the capture stream is no longer capturing; with
    ``gcoff`` the garbage collector is off around the warm-up and the
    capture; with ``threads`` the threads are printed at each capture; with
    ``gcon`` capture_forward leaves the collector as it is; with ``saveall``
    what a collection in a capture finds is kept and its types printed;
    with ``cycle`` a ForwardGraphs holds its forward strongly."""
    import gc
    import threading

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    import vision_tpu_torch.core.graph as graph

    def status() -> int:  # 0 none, 1 active, 2 invalidated
        st = ctypes.c_int()
        ctypes.CDLL("libcuda.so.1").cuStreamIsCapturing(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
                                                        ctypes.byref(st))
        return st.value

    class Watch(TorchDispatchMode):
        first, n = None, 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            Watch.n += 1
            if Watch.first is None and status() != 1:
                Watch.first = f"#{Watch.n} {func}"
            return out

    orig = graph.capture_forward
    if gcon:
        graph._no_collection = contextlib.nullcontext
    if cycle:
        graph._weakly = lambda fn: fn

    def capture_forward(fn, args, device, pool, stream):
        def run(*a):
            if not torch.cuda.is_current_stream_capturing():
                return fn(*a)
            Watch.first, Watch.n = None, 0
            try:
                if not watch:
                    return fn(*a)
                with Watch():
                    return fn(*a)
            except Exception:
                print("  raised inside the capture:\n" + traceback.format_exc()[-1500:], flush=True)
                raise
            finally:
                if watch:
                    print(f"  watch: first op leaving the capture inactive {Watch.first} of {Watch.n}", flush=True)

        if threads:
            native = len(os.listdir("/proc/self/task")) if os.path.isdir("/proc/self/task") else -1
            print(f"  threads at a capture: {[t.name for t in threading.enumerate()]}, {native} native", flush=True)
        if saveall:
            gc.set_debug(gc.DEBUG_SAVEALL)
            try:
                return orig(run, args, device, pool, stream)
            finally:
                gc.set_debug(0)
                kinds = collections.Counter(f"{type(o).__module__}.{type(o).__qualname__}" for o in gc.garbage)
                print(f"  saveall: {len(gc.garbage)} objects a collection in the capture found unreachable, "
                      f"{kinds.most_common(10)}", flush=True)
                gc.garbage.clear()
        if not gcoff:
            return orig(run, args, device, pool, stream)
        gc.collect()
        gc.disable()
        try:
            return orig(run, args, device, pool, stream)
        finally:
            gc.enable()

    graph.capture_forward = capture_forward


def hand_over(views: bool) -> None:
    """A tp-1 mesh gives each model the loader's tensors (or views of them)
    instead of placing them as DTensors."""
    from vision_tpu_torch.parallel import sharding

    orig = sharding.mesh_params

    def mesh_params(params, mesh, device, *a, **k):
        if sharding.mesh_tp(mesh) == 1:
            return {n: v.view_as(v) for n, v in params.items()} if views else dict(params)
        return orig(params, mesh, device, *a, **k)

    for name in ("birefnet", "depth_anything", "esrgan", "migan", "mobile_sam", "yolov9t", "sam3"):
        mod = importlib.import_module(f"vision_tpu_torch.models.{name}")
        if hasattr(mod, "mesh_params"):
            mod.mesh_params = mesh_params


def no_process_group() -> None:
    """The dry run's models without a mesh and without a process group:
    make_mesh gives None (each model then builds unmeshed), a None mesh
    reads as dp 1, and the dry run prints without asking for a rank."""
    from vision_tpu_torch.parallel import dryrun, sharding

    shape = sharding.mesh_shape
    sharding.make_mesh = lambda *a, **k: None
    sharding.mesh_shape = lambda mesh: {"dp": 1, "pp": 1, "sp": 1, "tp": 1} if mesh is None else shape(mesh)
    dryrun._say = lambda msg: print(msg, flush=True)


def run(variant: str) -> str:
    import numpy as np
    import torch
    import torch.distributed as dist

    from vision_tpu_torch.core.device import backend_init
    from vision_tpu_torch.parallel import init_distributed, make_mesh
    from vision_tpu_torch.parallel.runner import MeshEntry, stop_workers

    tokens = set(variant.split("_"))
    if "nopg" in tokens:
        no_process_group()
    else:
        init_distributed("file://" + os.path.join(tempfile.mkdtemp(), "store"), 1, 0)
    watch_captures("watch" in tokens, "gcoff" in tokens, "threads" in tokens, "gcon" in tokens, "saveall" in tokens,
                   "cycle" in tokens)
    if "cudafirst" in tokens:
        torch.cuda.init()
        torch.ones(8, 8, device="cuda") @ torch.ones(8, 8, device="cuda")
        torch.cuda.synchronize()
    if "dynamo" in tokens:
        queued = len(torch.cuda._queued_calls)
        import torch._dynamo  # noqa: F401

        added = [f"{getattr(fn, '__module__', '?')}.{getattr(fn, '__qualname__', fn)} "
                 f"({tb[-2].strip().splitlines()[0] if len(tb) > 1 else ''})"
                 for fn, tb in torch.cuda._queued_calls[queued:]]
        print(f"  queued: the card initialized before the import: {torch.cuda.is_initialized()}; the import queued "
              f"{len(added)} call(s) for its lazy initialization: {added[:8]}", flush=True)
    if "dtensor" in tokens:
        import torch.distributed.tensor  # noqa: F401
    if "loader" in tokens or "views" in tokens:
        hand_over(views="views" in tokens)
    distribute = MeshEntry._distribute
    if "nobcast" in tokens:
        MeshEntry._distribute = lambda self, t, scatter: t
    if "settle" in tokens:
        def settled(self, t, scatter):
            out = distribute(self, t, scatter)
            torch.cuda.synchronize()
            time.sleep(0.5)
            return out

        MeshEntry._distribute = settled
    dev = backend_init("gpu")
    try:
        if "dry" in tokens:
            from vision_tpu_torch.parallel import dryrun as d

            checks = [d._check_sam, d._check_esrgan, d._check_birefnet, d._check_servers]
            if "only" in tokens:
                checks = [d._check_birefnet]
            elif "first" in tokens:
                checks = [d._check_birefnet] + [c for c in checks if c is not d._check_birefnet]
            if "nopg" not in tokens:
                d._sam3_tp(1, 1, dev, "cuda")
            built = d._build(1, 1, dev, "cuda")
            if "sleep" in tokens:
                time.sleep(10)
            if "warm" in tokens:
                for key in ("mesh_tp", "mesh_dp", "da_mesh"):
                    for dim in ("dp", "tp"):
                        dist.broadcast(torch.ones(64, device="cuda"), src=0, group=built[key].get_group(dim))
            for check in checks:
                if "sync" in tokens:
                    torch.cuda.synchronize()
                check(built, dev)
            stop_workers()
        else:
            from vision_tpu_torch.core.weights import params_from_numpy
            from vision_tpu_torch.models.birefnet import BirefnetModel, BirefnetParams
            from vision_tpu_torch.models.random_weights import random_birefnet_params
            from vision_tpu_torch.models.swin import SWIN_T_PARAMS

            params = params_from_numpy(random_birefnet_params("tiny"), dev.torch_device, dev.preferred_float_type)
            mesh = None if "unmeshed" in tokens else make_mesh(1)
            model = BirefnetModel(params, BirefnetParams(image_size=64, image_extent=(64, 64), encoder=SWIN_T_PARAMS),
                                  dev, mesh=mesh)
            model.forward_u8(torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 64, 64, 3), np.uint8)))
            torch.cuda.synchronize()
        result = "ok"
    except Exception as e:  # noqa: BLE001 — the outcome is the result
        result = f"FAILED {type(e).__name__}: {str(e).splitlines()[0][:120]}"
    return (f"{variant}: {result} (torch._dynamo imported by the end: {'torch._dynamo' in sys.modules}; a process "
            f"group: {dist.is_initialized()})")


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(run(argv[1]), flush=True)
        return 0
    os.makedirs("chiprun_out", exist_ok=True)
    print(__doc__.split("\n\n")[1], flush=True)  # the finding
    for v in argv or DEFAULT_VARIANTS:
        t0 = time.time()
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", v], capture_output=True, text=True,
                             timeout=600, env=dict(os.environ, PYTHONPATH=os.getcwd()))
        with open(os.path.join("chiprun_out", f"capture_probe_{v}.log"), "w") as f:
            f.write(res.stdout + "\n---- stderr\n" + res.stderr)
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith(v + ":") or ln.startswith("  watch")
                 or ln.startswith("  threads") or ln.startswith("  queued") or ln.startswith("  saveall")][:6]
        print("\n".join(lines) or f"{v}: no result, rc {res.returncode}\n{res.stderr[-1500:]}",
              f"[{time.time() - t0:.1f} s]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
