"""The port's model-level C ABI (vision_tpu_torch/capi.py and
native/c_api.cpp) on the CPU: ``capi.model_compute`` against the JAX
package's ``vision_tpu.capi.model_compute`` for each family on the small
GGUFs of test_torch_api.py (uint8 outputs within one level on at most 0.1%
of the values, as test_torch_cli.py holds the CLIs); the shim through
``ctypes`` and from a C program compiled with ``gcc``, on
``visp_device_init(1)``, equal to the in-process call; the error paths; and
YOLOv9t's drawn detections. Skips only where this interpreter has no
``Python.h`` (as tests/test_capi.py does where the JAX shim is not built)."""

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_api import FAMILIES, sample_image, write_family_gguf
from vision_tpu import capi as jcapi
from vision_tpu_torch import capi

REPO = Path(__file__).resolve().parents[1]
MAX_SHARE_OFF = 1e-3


class VispImageView(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("stride", ctypes.c_int32),
        ("format", ctypes.c_int32),
        ("data", ctypes.c_void_p),
    ]


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("capi")
    return {family: write_family_gguf(family, d) for family in FAMILIES}


@pytest.fixture(scope="module")
def shim():
    """The shim built and loaded (ctypes), visp_init'ed on this repo."""
    import sysconfig

    if not (Path(sysconfig.get_paths()["include"]) / "Python.h").is_file():
        pytest.skip("this interpreter has no Python.h: the C ABI cannot be built")
    from vision_tpu_torch.native import build_capi

    lib = ctypes.CDLL(str(build_capi()))
    lib.visp_get_last_error.restype = ctypes.c_char_p
    lib.visp_init.argtypes = [ctypes.c_char_p]
    lib.visp_device_init.argtypes = [ctypes.c_int32, ctypes.POINTER(ctypes.c_void_p)]
    lib.visp_device_type.argtypes = [ctypes.c_void_p]
    lib.visp_device_destroy.argtypes = [ctypes.c_void_p]
    lib.visp_model_detect_family.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32)]
    lib.visp_model_load.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int32,
                                    ctypes.POINTER(ctypes.c_void_p)]
    lib.visp_model_destroy.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.visp_image_destroy.argtypes = [ctypes.c_void_p]
    lib.visp_model_compute.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(VispImageView), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.POINTER(VispImageView),
        ctypes.POINTER(ctypes.c_void_p),
    ]
    assert lib.visp_init(str(REPO).encode()) == 1, lib.visp_get_last_error()
    return lib


def _inputs(family):
    """(images as the ABI's tuples, args) of one request of ``family``."""
    rgb = np.ascontiguousarray(sample_image(72, 96))
    images = [(96, 72, 96 * 3, 3, rgb.tobytes())]  # 3 = rgb_u8
    if family == "migan":
        mask = np.zeros((72, 96, 1), np.uint8)
        mask[20:50, 30:70] = 255
        images.append((96, 72, 96, 4, mask.tobytes()))  # 4 = alpha_u8
    args = {"sam": [40, 30], "yolov9t": [10, 450]}.get(family, [])
    return images, args


def _pixels(result):
    data, w, h, stride, fmt = result
    return np.asarray(data).reshape(h, stride)[:, : stride].copy(), (w, h, stride, fmt)


def _close(a, b):
    diff = np.abs(a.astype(int) - b.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= MAX_SHARE_OFF, (diff.max(), (diff > 0).mean())


def test_tables_match_jax():
    assert capi.FAMILIES == jcapi.FAMILIES
    assert [f.value for f in capi.FORMATS] == [f.value for f in jcapi.FORMATS]


@pytest.mark.parametrize("family", capi.FAMILIES)
def test_model_compute_matches_jax(family, ggufs):
    key = "depthany" if family == "depth_anything" else family
    images, args = _inputs(family)
    dev, jdev = capi.device_init(1), jcapi.device_init(1)
    assert capi.device_type(dev) == jcapi.device_type(jdev) == 1 and capi.device_name(dev) == "cpu"
    handle = capi.model_load(ggufs[key], dev, -1)
    jhandle = jcapi.model_load(ggufs[key], jdev, -1)
    assert handle[1] == jhandle[1] == capi.FAMILIES.index(family)
    got, got_meta = _pixels(capi.model_compute(handle, images, args))
    want, want_meta = _pixels(jcapi.model_compute(jhandle, images, args))
    assert got_meta == want_meta
    _close(got, want)


def test_image_from_raw_reads_strides_and_unpadded_last_rows():
    a = np.arange(4 * 5 * 3, dtype=np.uint8).reshape(4, 5, 3)
    padded = np.zeros((4, 20), np.uint8)
    padded[:, :15] = a.reshape(4, 15)
    for data in (padded.tobytes(), padded.tobytes()[: 20 * 3 + 15]):
        img = capi._image_from_raw(5, 4, 20, 3, data)
        jimg = jcapi._image_from_raw(5, 4, 20, 3, data)
        assert np.array_equal(img.data, a) and np.array_equal(img.data, jimg.data)
    f = np.random.default_rng(0).standard_normal((3, 2, 4)).astype(np.float32)
    assert np.array_equal(capi._image_from_raw(2, 3, 32, 5, f.tobytes()).data, f)  # 5 = rgba_f32
    with pytest.raises(ValueError, match="does not match"):
        capi._image_from_raw(5, 4, 20, 3, b"\0" * 7)
    with pytest.raises(ValueError, match="invalid image format code 9"):
        capi._image_from_raw(5, 4, 20, 9, b"")


def test_error_paths(ggufs, tmp_path):
    dev = capi.device_init(1)
    with pytest.raises(ValueError, match="unknown model family code 7"):
        capi.model_load(ggufs["esrgan"], dev, 7)
    with pytest.raises(ValueError, match="model file is 'esrgan' but family 'sam' was requested"):
        capi.model_load(ggufs["esrgan"], dev, 0)
    handle = capi.model_load(ggufs["esrgan"], dev, 4)
    images, _ = _inputs("esrgan")
    with pytest.raises(ValueError, match="Expected 1 input images, but got 2"):
        capi.model_compute(handle, images * 2, [])
    sam = capi.model_load(ggufs["sam"], dev, 0)
    with pytest.raises(ValueError, match="sam: bad number of arguments"):
        capi.model_compute(sam, images, [1, 2, 3])


def _view(arr, fmt):
    h, w, c = arr.shape
    return VispImageView(width=w, height=h, stride=w * c * arr.itemsize, format=fmt,
                         data=arr.ctypes.data_as(ctypes.c_void_p).value)


@pytest.mark.parametrize("family,args", [("esrgan", []), ("yolov9t", [10, 450])])
def test_shim_through_ctypes_equals_model_compute(family, args, shim, ggufs):
    dev = ctypes.c_void_p()
    assert shim.visp_device_init(1, ctypes.byref(dev)) == 1, shim.visp_get_last_error()
    assert shim.visp_device_type(dev) == 1
    fam = ctypes.c_int32(-1)
    assert shim.visp_model_detect_family(ggufs[family].encode(), ctypes.byref(fam)) == 1
    assert fam.value == capi.FAMILIES.index(family)
    model = ctypes.c_void_p()
    assert shim.visp_model_load(ggufs[family].encode(), dev, -1, ctypes.byref(model)) == 1, (
        shim.visp_get_last_error())
    rgb = np.ascontiguousarray(sample_image(72, 96))
    inputs = (VispImageView * 1)(_view(rgb, 3))
    c_args = (ctypes.c_int32 * max(len(args), 1))(*args)
    out, out_data = VispImageView(), ctypes.c_void_p()
    ok = shim.visp_model_compute(model, fam.value, inputs, 1, c_args, len(args), ctypes.byref(out),
                                 ctypes.byref(out_data))
    assert ok == 1, shim.visp_get_last_error()
    got = np.ctypeslib.as_array(ctypes.cast(out.data, ctypes.POINTER(ctypes.c_uint8)),
                                shape=(out.height, out.stride)).copy()
    want, (w, h, stride, fmt) = _pixels(capi.model_compute(capi.model_load(ggufs[family], capi.device_init(1), -1),
                                                          [(96, 72, 288, 3, rgb.tobytes())], args))
    assert (out.width, out.height, out.stride, out.format) == (w, h, stride, fmt)
    assert np.array_equal(got, want)
    if family == "yolov9t":  # the detections are drawn on a copy of the input
        assert fmt == 3 and not np.array_equal(got.reshape(72, 96, 3), rgb)
        bad = (ctypes.c_int32 * 1)(10)
        assert shim.visp_model_compute(model, 5, inputs, 1, bad, 1, ctypes.byref(out), ctypes.byref(out_data)) == 0
        assert "yolov9t: bad number of arguments" in shim.visp_get_last_error().decode()
    shim.visp_image_destroy(out_data)
    shim.visp_model_destroy(model, fam.value)
    shim.visp_device_destroy(dev)


def test_shim_error_codes(shim, ggufs, tmp_path):
    dev = ctypes.c_void_p()
    assert shim.visp_device_init(1, ctypes.byref(dev)) == 1
    model = ctypes.c_void_p()
    assert shim.visp_model_load(str(tmp_path / "nope.gguf").encode(), dev, -1, ctypes.byref(model)) == 0
    err = shim.visp_get_last_error().decode()
    assert "nope.gguf" in err or "No such file" in err
    assert shim.visp_model_load(ggufs["esrgan"].encode(), dev, 0, ctypes.byref(model)) == 0  # 0 = sam
    assert "esrgan" in shim.visp_get_last_error().decode()
    assert shim.visp_device_init(1, None) == 0
    assert "out_device is NULL" in shim.visp_get_last_error().decode()
    shim.visp_device_destroy(dev)


def test_c_program_drives_the_shim(shim, ggufs, tmp_path):
    """A C program (no host interpreter) initializes Python through the shim
    and runs a model; its output file equals the in-process call."""
    from vision_tpu_torch.native import build_capi

    src = tmp_path / "main.c"
    src.write_text(r'''
#include <stdio.h>
#include <stdint.h>
#include <stdlib.h>
typedef struct { int32_t width, height, stride, format; void* data; } view;
extern const char* visp_get_last_error(void);
extern int32_t visp_init(const char* dir);
extern int32_t visp_device_init(int32_t type, void** out);
extern int32_t visp_device_type(const void*);
extern int32_t visp_model_detect_family(const char*, int32_t*);
extern int32_t visp_model_load(const char*, const void*, int32_t, void**);
extern int32_t visp_model_compute(void*, int32_t, const view*, int32_t, const int32_t*, int32_t, view*, void**);
extern void visp_image_destroy(void*);
extern void visp_model_destroy(void*, int32_t);
extern void visp_device_destroy(void*);

int main(int argc, char** argv) {
    if (!visp_init(argv[1])) { printf("init failed: %s\n", visp_get_last_error()); return 1; }
    void* dev = 0;
    if (!visp_device_init(1, &dev)) { printf("dev failed: %s\n", visp_get_last_error()); return 1; }
    printf("device type %d\n", visp_device_type(dev));
    void* model = 0;
    if (visp_model_load("/does/not/exist.gguf", dev, -1, &model)) { printf("unexpected ok\n"); return 1; }
    printf("expected error: %s\n", visp_get_last_error());
    int32_t fam = -1;
    if (!visp_model_detect_family(argv[2], &fam)) { printf("detect failed: %s\n", visp_get_last_error()); return 1; }
    if (!visp_model_load(argv[2], dev, fam, &model)) { printf("load failed: %s\n", visp_get_last_error()); return 1; }
    int w = 24, h = 20;
    unsigned char* rgb = malloc(w * h * 3);
    for (int i = 0; i < w * h * 3; ++i) rgb[i] = (unsigned char)(i * 7 % 251);
    view in = {w, h, w * 3, 3, rgb}, out;
    void* img = 0;
    if (!visp_model_compute(model, fam, &in, 1, 0, 0, &out, &img)) { printf("compute failed: %s\n", visp_get_last_error()); return 1; }
    FILE* f = fopen(argv[3], "wb");
    fwrite(out.data, 1, (size_t)out.stride * out.height, f);
    fclose(f);
    printf("out %d %d %d %d\n", out.width, out.height, out.stride, out.format);
    visp_image_destroy(img);
    visp_model_destroy(model, fam);
    visp_device_destroy(dev);
    free(rgb);
    printf("C-EMBED-OK\n");
    return 0;
}
''')
    lib = build_capi()
    exe = tmp_path / "main"
    subprocess.run(["gcc", str(src), "-o", str(exe), str(lib), f"-Wl,-rpath,{lib.parent}"], check=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), *sys.path[1:]]))
    r = subprocess.run([str(exe), str(REPO), ggufs["esrgan"], str(tmp_path / "out.bin")], capture_output=True,
                       text=True, env=env, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "C-EMBED-OK" in r.stdout and "device type 1" in r.stdout and "expected error" in r.stdout, r.stdout
    rgb = np.arange(20 * 24 * 3, dtype=np.int64).reshape(20, 24, 3) * 7 % 251
    want, (w, h, stride, fmt) = _pixels(capi.model_compute(capi.model_load(ggufs["esrgan"], capi.device_init(1), -1),
                                                          [(24, 20, 72, 3, rgb.astype(np.uint8).tobytes())], []))
    assert f"out {w} {h} {stride} {fmt}" in r.stdout
    assert np.array_equal(np.fromfile(tmp_path / "out.bin", np.uint8).reshape(h, stride), want)
