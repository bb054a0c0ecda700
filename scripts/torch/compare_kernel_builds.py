#!/usr/bin/env python
"""Compare kernels of two checkouts on one card: the fp32 SGEMM kernels,
fc1+GELU (``ssl4polyp_fc1_gelu_fwd_f32``, h and y written) and LN+QKV
(``ssl4polyp_ln_linear_fwd_f32``) at ViT-B's and the MAE decoder's widths
over 12,608 rows; and the bf16 attention forward and backward
(``ssl4polyp_qkv_attention_fwd``, ``ssl4polyp_qkv_attention_bwd_mode``, with a
bias) at the classifier's 197 tokens (12 heads of 64, fp32 scores), the MAE
decoder's (16 heads of 32, bf16 scores) and 256 tokens.  Both builds run on
the same seeded inputs: their outputs must be equal bit for bit, and each
build's time is taken in turns (other, this, this, other) as the median of 5
batches of 20 launches.

Each checkout's kernel library is built by its own ``ops._build`` in a
subprocess, then both are loaded into this process with ctypes.  Run from
the root of one checkout, with the other unpacked elsewhere (for example
``git archive <commit> | tar -x -C build/other``):

    python scripts/torch/compare_kernel_builds.py --other build/other

Exits 1 if any output differs.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
# (entry point, shape): fc1+GELU's (rows, in, hidden), LN+QKV's (rows, in,
# 3 D); the attention's (B, N, heads, head dim, fp32 scores).
ATTENTION_SHAPES = [(64, 197, 12, 64, 1), (64, 197, 16, 32, 0), (16, 256, 12, 64, 1)]
CASES = [("fc1_gelu", (12608, 768, 3072)), ("fc1_gelu", (12608, 512, 2048)),
         ("ln_linear", (12608, 768, 2304)), ("ln_linear", (12608, 512, 1536)),
         *[(name, shape) for name in ("attention", "attention_backward")
           for shape in ATTENTION_SHAPES]]
EPS = 1e-6


def build(root: Path) -> Path:
    """The checkout's kernel library, built by its own ``_build``."""
    code = ("from ssl4polyp_tpu_torch.ops import _build; _build.library(); "
            "print(_build.library_path())")
    done = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"building {root} failed:\n{done.stdout}{done.stderr}")
    return Path(done.stdout.strip().splitlines()[-1])


def entry_points(path: Path) -> dict:
    lib = ctypes.CDLL(str(path))  # RTLD_LOCAL: each library keeps its own symbols
    fc1 = lib.ssl4polyp_fc1_gelu_fwd_f32
    fc1.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    ln = lib.ssl4polyp_ln_linear_fwd_f32
    ln.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    fwd = lib.ssl4polyp_qkv_attention_fwd
    fwd.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    bwd = lib.ssl4polyp_qkv_attention_bwd_mode
    bwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                    + [ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fc1.restype = ln.restype = fwd.restype = bwd.restype = ctypes.c_int
    return {"fc1_gelu": fc1, "ln_linear": ln, "attention": fwd, "attention_backward": bwd}


def attention_launcher(fn, name: str, shape, gen: torch.Generator):
    """launcher() for the bf16 attention forward or backward."""
    b, n, h, hd, f32 = shape
    d = h * hd
    randn = lambda *s, scale=1.0: (torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
                                   * scale).to(torch.bfloat16)
    qkv, bias, dout = randn(b, n, 3 * d), randn(3 * d, scale=0.5), randn(b, n, d)
    scale_c = float(torch.tensor(hd ** -0.5, dtype=torch.bfloat16))
    stream = torch.cuda.current_stream().cuda_stream
    if name == "attention":
        out = torch.empty(b, n, d, dtype=torch.bfloat16, device="cuda")
        args = (qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), b, n, h, hd, n, scale_c, f32,
                stream)
        outputs = (out,)
    else:
        dqkv = torch.empty_like(qkv)
        part = torch.empty(b, 3 * d, device="cuda")
        dbias = torch.empty(3 * d, device="cuda")
        args = (qkv.data_ptr(), bias.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
                part.data_ptr(), dbias.data_ptr(), b, n, h, hd, n, scale_c, hd ** -0.5, f32, 0, 0,
                stream)
        outputs = (dqkv, dbias)
    tensors = (qkv, bias, dout, *outputs)

    def run(tensors=tensors):
        err = fn(*args)
        if err:
            raise SystemExit(f"{name} launch failed: CUDA error {err}")

    return run, outputs


def launcher(fn, name: str, shape, gen: torch.Generator):
    """A closure that launches ``fn`` on fixed inputs (which it keeps
    alive), and its outputs."""
    if name.startswith("attention"):
        return attention_launcher(fn, name, shape, gen)
    m, k, n = shape
    randn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")  # noqa: E731
    x, w, b = randn(m, k), randn(n, k) * k ** -0.5, randn(n) * 0.5
    stream = torch.cuda.current_stream().cuda_stream
    if name == "fc1_gelu":
        h, y = torch.empty(m, n, device="cuda"), torch.empty(m, n, device="cuda")
        args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), h.data_ptr(), y.data_ptr(), m, k, n,
                stream)
        outputs = (h, y)
        tensors = (x, w, b, h, y)
    else:
        s, t = 1.0 + 0.1 * randn(k), 0.1 * randn(k)
        stats, out = torch.empty(m, 2, device="cuda"), torch.empty(m, n, device="cuda")
        args = (x.data_ptr(), s.data_ptr(), t.data_ptr(), w.data_ptr(), b.data_ptr(),
                stats.data_ptr(), out.data_ptr(), m, k, n, EPS, stream)
        outputs = (out,)
        tensors = (x, s, t, w, b, stats, out)

    def run(tensors=tensors):
        err = fn(*args)
        if err:
            raise SystemExit(f"{name} launch failed: CUDA error {err}")

    return run, outputs


def time_ms(run, iters: int = 20, batches: int = 5) -> float:
    for _ in range(3):
        run()
    times = []
    for _ in range(batches):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", type=Path, required=True,
                        help="root of the other checkout (its sources only)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    libs = {"other": entry_points(build(args.other.resolve())), "this": entry_points(build(ROOT))}
    rows, same = [], True
    for name, shape in CASES:
        runs, outputs = {}, {}
        for label, lib in libs.items():
            gen = torch.Generator(device="cuda").manual_seed(0)  # the same inputs for both
            runs[label], outputs[label] = launcher(lib[name], name, shape, gen)
            runs[label]()
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(outputs["other"], outputs["this"]))
        same &= equal
        order = ("other", "this", "this", "other")
        times = {label: [] for label in libs}
        for label in order:
            times[label].append(time_ms(runs[label]))
        row = {"kernel": name, "shape": list(shape), "bit_equal": equal,
               **{f"{label}_ms": times[label] for label in libs}}
        rows.append(row)
        print(f"{name} {shape}: outputs bit-equal {equal}; other "
              f"{times['other'][0]:.4f} / {times['other'][1]:.4f} ms, this "
              f"{times['this'][0]:.4f} / {times['this'][1]:.4f} ms; {card}")
    print(json.dumps({"card": card, "cases": rows}))
    if not same:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
