"""The port's C API from plain C: ``tests/c_api_main.c`` (unchanged, the
JAX package's C caller) compiled against the port's header copy
``dlaf_tpu_torch/native/dlaf_tpu_c.h`` and shim
(``dlaf_tpu_torch.native.build_c_api``), run as four CPU ranks of one
process group (RANK/WORLD_SIZE/MASTER_ADDR/MASTER_PORT, gloo): its 2x2
grid is the four processes, each passing the whole matrix and checking
the whole result, so each must exit 0 and print OK. A single process
asking for that grid must fail (one process per rank). Then the port's
own card driver (``dlaf_tpu_torch/native/dlaf_card_driver.c``:
``dlaf_pspotrf`` and ``dlaf_pssyevd`` checked in C) on a 1x1 grid at a
small n, on the CPU (``DLAF_TPU_TORCH_DEVICE=cpu``), and with the card
asked for where there is none (it must fail).
"""
import json
import os
import shutil
import socket
import subprocess

import pytest
import torch

from dlaf_tpu_torch import native
from dlaf_tpu_torch.native import c_entry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.skipif(shutil.which("gcc") is None, reason="no C compiler")


def _compile(src, out):
    lib = native.build_c_api()
    r = subprocess.run(["gcc", "-O2", src, "-I", str(native.HERE), "-L", str(lib.parent),
                        f"-l{native.C_API_NAME}", f"-Wl,-rpath,{lib.parent}", "-lm", "-o", out],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return out


def _env(**kw):
    env = dict(os.environ, OMP_NUM_THREADS="1", **kw)
    env[c_entry.DEVICE_ENV] = kw.get(c_entry.DEVICE_ENV, "cpu")
    return env


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_c_api_main_four_ranks(tmp_path):
    exe = _compile(os.path.join(ROOT, "tests", "c_api_main.c"), str(tmp_path / "c_api_main"))
    port = str(_free_port())
    procs = [subprocess.Popen([exe], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=str(tmp_path),
                              env=_env(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="4",
                                       MASTER_ADDR="localhost", MASTER_PORT=port))
             for r in range(4)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (r, p.returncode, out[-500:], err[-2000:])
        assert "OK" in out, (r, out)
    # one process cannot make the 2x2 grid: dlaf_create_grid fails (exit 2)
    r = subprocess.run([exe], capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
                       env=_env())
    assert r.returncode == 2, (r.returncode, r.stdout[-500:], r.stderr[-2000:])


def test_card_driver_small(tmp_path):
    exe = _compile(str(native.HERE / "dlaf_card_driver.c"), str(tmp_path / "card_driver"))
    r = subprocess.run([exe, "384", "256", "64"], capture_output=True, text=True, timeout=300,
                       cwd=str(tmp_path), env=_env())
    assert r.returncode == 0, (r.returncode, r.stdout[-500:], r.stderr[-2000:])
    line = json.loads(r.stdout.strip().splitlines()[-1])["card_driver"]
    assert line["potrf_n"] == 384 and line["syevd_n"] == 256 and line["ascending"] == 1
    for k, bound in line["bounds"].items():
        assert line[k] <= bound, (k, line)
    if not torch.cuda.is_available():
        r = subprocess.run([exe, "64", "64", "16"], capture_output=True, text=True, timeout=300,
                           cwd=str(tmp_path), env=_env(**{c_entry.DEVICE_ENV: "cuda"}))
        assert r.returncode == 1 and "no CUDA device" in r.stderr, (r.returncode, r.stderr[-500:])


def test_build_is_reused():
    """A second build returns the same library without compiling."""
    a = native.build_c_api()
    mtime = a.stat().st_mtime_ns
    assert native.build_c_api() == a and a.stat().st_mtime_ns == mtime
    assert native.build_native().exists()
