"""The port's spans (utils/profiling.py ``span``, ``spans``, ``dropped``) on
the CPU: the ring's bound and its count of evicted records; ids, parents
and threads; CPU time within wall time; the serving layer's spans around
every batch of ``EsrganServer`` and of ``ImageServer`` (BiRefNet at test
widths), with each batch's request ids those of its requests' spans, and
the bytes of its copy back; a
cancelled request and a failing batch still closing theirs; no graph
captured on the CPU; and ``--profile`` adding the batch worker's spans to
the Chrome trace of a bulk run."""

import collections
import json
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image as PILImage

import vision_tpu_torch.cli as tcli
from vision_tpu_torch.core.device import backend_init
from vision_tpu_torch.core.gguf import GGUFWriter
from vision_tpu_torch.core.weights import params_from_numpy
from vision_tpu_torch.image import Image, ImageFormat
from vision_tpu_torch.models.birefnet import birefnet_load_model
from vision_tpu_torch.models.esrgan import EsrganModel, EsrganParams
from vision_tpu_torch.models.random_weights import random_birefnet_params, random_esrgan_params
from vision_tpu_torch.serve import BatchServer, EsrganServer, ImageServer
from vision_tpu_torch.utils import profiling
from vision_tpu_torch.utils.profiling import dropped, span, spans
from torch_threads import torch_threads  # noqa: F401

ID, NAME, START, END, CPU, THREAD, PARENT, ATTRS = range(8)
# a batch's children on the CPU, in order (serve.wait waits for the card only)
PHASES = ["serve.stack", "serve.forward", "serve.copy_back", "serve.post", "serve.deliver"]


def _since(t0: int) -> list:
    return [r for r in spans() if r[START] >= t0]


def _img(seed, w, h):
    rng = np.random.default_rng(seed)
    return Image(rng.integers(0, 256, (h, w, 4), np.uint8), ImageFormat.rgba_u8)


def test_the_ring_keeps_the_newest_records_and_counts_the_rest(monkeypatch):
    assert profiling._ring.maxlen == profiling._RING_RECORDS == 1 << 16
    monkeypatch.setattr(profiling, "_ring", collections.deque(maxlen=4))
    monkeypatch.setattr(profiling, "_RING_RECORDS", 4)
    monkeypatch.setattr(profiling, "_dropped", 0)
    for i in range(10):
        with span(f"s{i}", i=i):
            pass
    assert [r[NAME] for r in spans()] == ["s6", "s7", "s8", "s9"] and dropped() == 6
    assert [r[ATTRS] for r in spans()] == [(("i", i),) for i in range(6, 10)]


def test_ids_parents_and_threads():
    t0 = time.perf_counter_ns()
    other = {}

    def work():
        with span("other") as sid:
            other["sid"], other["tid"] = sid, threading.get_native_id()

    with span("outer", n=3, shape=(2, 4)) as outer:
        with span("inner") as inner:
            thread = threading.Thread(target=work)
            thread.start()
            thread.join(timeout=30)
        with span("sibling", parent=0) as sibling:
            pass
    assert not thread.is_alive()
    by = {r[NAME]: r for r in _since(t0)}
    assert len({outer, inner, sibling, other["sid"]}) == 4 and outer < inner < sibling
    assert [by[n][ID] for n in ("outer", "inner", "sibling")] == [outer, inner, sibling]
    assert by["outer"][PARENT] == 0 and by["inner"][PARENT] == outer and by["sibling"][PARENT] == 0
    assert by["other"][PARENT] == 0  # another thread's spans do not nest under this one's
    me = threading.get_native_id()
    assert by["outer"][THREAD] == by["inner"][THREAD] == me and by["other"][THREAD] == other["tid"] != me
    assert by["outer"][ATTRS] == (("n", 3), ("shape", (2, 4)))
    assert by["outer"][START] <= by["inner"][START] <= by["inner"][END] <= by["outer"][END]
    # records are ints and strings in tuples: nothing for the cyclic collector to track
    assert all(type(v) in (int, str, tuple) for r in by.values() for v in r)


def test_cpu_time_is_at_most_wall_time():
    t0 = time.perf_counter_ns()
    with span("busy"):
        end = time.perf_counter() + 0.03
        while time.perf_counter() < end:
            pass
    with span("asleep"):
        time.sleep(0.05)
    begun = profiling._begin("handed over", 0, ())
    thread = threading.Thread(target=profiling._end, args=(begun,))
    thread.start()
    thread.join(timeout=30)
    by = {r[NAME]: r for r in _since(t0)}
    for name in ("busy", "asleep"):
        assert 0 <= by[name][CPU] <= by[name][END] - by[name][START], by[name]
    assert by["busy"][CPU] > 0 and by["asleep"][CPU] < 0.5 * (by["asleep"][END] - by["asleep"][START])
    assert by["handed over"][CPU] == -1 and by["handed over"][THREAD] == threading.get_native_id()


def _check_batches(records, n_requests):
    """Every batch's children in order on its thread, and every request of
    the run in exactly one batch, with its request and prep spans."""
    batches = [r for r in records if r[NAME] == "serve.batch"]
    requests = {dict(r[ATTRS])["req"]: r for r in records if r[NAME] == "serve.request"}
    preps = {dict(r[ATTRS])["req"]: r for r in records if r[NAME] == "serve.prep"}
    assert batches and len(requests) == len(preps) == n_requests
    seen = []
    for b in batches:
        attrs = dict(b[ATTRS])
        kids = sorted((r for r in records if r[PARENT] == b[ID]), key=lambda r: r[START])
        assert [r[NAME] for r in kids] == PHASES, [r[NAME] for r in kids]
        assert all(r[THREAD] == b[THREAD] and b[START] <= r[START] <= r[END] <= b[END] for r in kids)
        assert all(a[END] <= z[START] for a, z in zip(kids, kids[1:]))
        assert b[PARENT] == 0 and attrs["items"] == len(attrs["reqs"]) and attrs["batch"] >= attrs["items"]
        for rid in attrs["reqs"]:
            req, prep = requests[rid], preps[rid]
            assert req[PARENT] == 0 and prep[PARENT] == req[ID] and prep[THREAD] != b[THREAD]
            assert req[START] <= prep[START] <= prep[END] <= b[START] and kids[-1][START] <= req[END]
        seen += attrs["reqs"]
    assert sorted(seen) == sorted(requests)
    assert all(r[THREAD] == threading.get_native_id() for r in requests.values())


@pytest.fixture(scope="module")
def esrgan():
    store = {k: v * 25 for k, v in random_esrgan_params(1, nf=8, nb=1, gc=4).items()}
    return EsrganModel(params_from_numpy(store, "cpu", torch.float32), EsrganParams(4, 1), backend_init("cpu"))


def test_esrgan_server_records_each_batch(esrgan):
    t0 = time.perf_counter_ns()
    with EsrganServer(esrgan, batch_size=2, max_delay_ms=200) as srv:
        results = [f.result(timeout=300) for f in [srv.submit(_img(i, 24, 20)) for i in range(3)]]
    assert all(r.extent == (96, 80) for r in results)
    records = _since(t0)
    _check_batches(records, 3)
    assert esrgan.graphs.captures == 0 and not [r for r in records if r[NAME] == "graph.capture"]


def test_esrgan_copy_back_records_the_rgba_bytes(esrgan):
    """Each batch's ``serve.copy_back`` carries ``bytes``: its answers'
    total, four channels at 4x the extent an answer."""
    t0 = time.perf_counter_ns()
    with EsrganServer(esrgan, batch_size=2, max_delay_ms=200) as srv:
        results = [f.result(timeout=300) for f in [srv.submit(_img(i, 24, 20)) for i in range(3)]]
    assert all(r.data.shape == (80, 96, 4) for r in results)
    records = _since(t0)
    items = {r[ID]: dict(r[ATTRS])["items"] for r in records if r[NAME] == "serve.batch"}
    copies = [(dict(r[ATTRS])["bytes"], items[r[PARENT]]) for r in records if r[NAME] == "serve.copy_back"]
    assert sorted(n for _, n in copies) == sorted(items.values()) and sum(items.values()) == 3
    assert all(b == n * 80 * 96 * 4 for b, n in copies), copies


@pytest.fixture(scope="module")
def birefnet(tmp_path_factory):
    path = tmp_path_factory.mktemp("spans_birefnet") / "birefnet-tiny.gguf"
    w = GGUFWriter(path, "birefnet")
    w.add("birefnet.image_size", 64)
    w.add("birefnet.image_multiple", 32)
    w.add("swin.embed_dim", 96)
    for name, a in random_birefnet_params("tiny", seed=0).items():
        w.add_tensor(name, a)
    w.write()
    return birefnet_load_model(str(path), backend_init("cpu"))


def test_image_server_records_each_batch(birefnet):
    t0 = time.perf_counter_ns()
    with ImageServer(birefnet, batch_size=2, max_delay_ms=200) as srv:
        results = [f.result(timeout=300) for f in [srv.submit(_img(10 + i, 80, 60)) for i in range(2)]]
    assert all(r.format == ImageFormat.alpha_u8 for r in results)
    _check_batches(_since(t0), 2)
    assert birefnet.graphs.captures == 0


def test_a_cancelled_request_and_a_failing_batch_close_their_spans():
    t0 = time.perf_counter_ns()
    gate = threading.Event()

    def held(items):
        gate.wait(timeout=60)
        return items

    with BatchServer(held, batch_size=1, max_delay_ms=0) as srv:
        first = srv.submit("a")
        deadline = time.monotonic() + 60
        while not first.running() and time.monotonic() < deadline:  # until the worker holds it
            time.sleep(0.001)
        second = srv.submit("b")
        assert second.cancel()
        gate.set()
        assert first.result(timeout=60) == "a"
    names = [r[NAME] for r in _since(t0)]
    assert names.count("serve.request") == 2 and names.count("serve.batch") == 1

    def failing(items):
        if items == ["bad"]:
            raise ValueError("bad batch")
        return items

    def prepare(item):
        if item == "unprepared":
            raise ValueError("bad item")
        return item

    t1 = time.perf_counter_ns()
    with BatchServer(failing, batch_size=1, max_delay_ms=0, prepare=prepare) as srv:
        with pytest.raises(ValueError, match="bad batch"):
            srv.submit("bad").result(timeout=60)
        with pytest.raises(ValueError, match="bad item"):
            srv.submit("unprepared").result(timeout=60)
        assert srv.submit("good").result(timeout=60) == "good"
    records = _since(t1)
    names = [r[NAME] for r in records]
    assert names.count("serve.request") == names.count("serve.prep") == 3
    assert names.count("serve.batch") == 2 and names.count("serve.deliver") == 2
    # the failure left no span open on the worker: the next batch is a root again
    for b in (r for r in records if r[NAME] == "serve.batch"):
        assert b[PARENT] == 0
        assert [r[NAME] for r in records if r[PARENT] == b[ID]] == ["serve.deliver"]


def test_profile_adds_the_workers_spans_to_the_trace(tmp_path, capsys):
    store = {k: v * 5 for k, v in random_esrgan_params(1, nf=8, nb=1, gc=4).items()}
    w = GGUFWriter(tmp_path / "esrgan.gguf", "esrgan")
    w.add("esrgan.scale", 4)
    w.add("esrgan.block_count", 1)
    for k, a in store.items():
        w.add_tensor(k, a)
    w.write()
    (tmp_path / "in").mkdir()
    for i in range(2):
        PILImage.fromarray(_img(i, 24, 16).data).save(tmp_path / "in" / f"{i}.png")
    rc = tcli.main(["esrgan", "-m", str(tmp_path / "esrgan.gguf"), "-b", "cpu", "-i", str(tmp_path / "in"),
                    "-o", str(tmp_path / "out"), "--profile", str(tmp_path / "prof")])
    assert rc == 0, capsys.readouterr().err
    (trace,) = (tmp_path / "prof").glob("*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    ours = [e for e in events if e.get("cat") == "span"]
    batches = [e for e in ours if e["name"] == "serve.batch"]
    assert batches and all(e["ph"] == "X" and e["dur"] > 0 for e in batches)
    worker = {e["tid"] for e in batches}
    assert len(worker) == 1 and threading.get_native_id() not in worker
    assert {e["name"] for e in ours if e["tid"] in worker} >= set(PHASES)
    # on the profiler's clock: the spans lie within the profiled block's host events
    own = [e for e in events if e.get("ph") == "X" and e.get("cat") != "span"]
    lo, hi = min(e["ts"] for e in own), max(e["ts"] + e["dur"] for e in own)
    assert all(lo - 5e5 <= e["ts"] <= e["ts"] + e["dur"] <= hi + 5e5 for e in batches), (lo, hi, batches)
