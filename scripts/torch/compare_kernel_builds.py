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

Then, through each checkout's own wrappers in a process of its own (their
call signatures are the same in both), the attention kernels that take a
layout as a template parameter and what is composed on them, again at fixed
seeds and bit for bit: the QKV attention in fp32 (forward with its
log-sum-exp, backward in both scale placements) and in bf16 past 256 tokens
(the key tiles, both placements), the attention+projection fold and the QKV
projection + attention in bf16 past 256 tokens and in fp32 (untimed).

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
import tempfile
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
# Run in each checkout (cwd), writing a dict of output tensors to argv[1]:
# (tokens, heads, head dim, valid_len) of each case, B 8 (4 at 1,025).
WRAPPER_OUTPUTS = r"""
import sys
import torch
from ssl4polyp_tpu_torch.ops import attention_block, attn_proj, qkv_attention

torch.backends.cuda.matmul.allow_tf32 = False
outputs = {}


def randn(seed, *shape, dtype, scale=1.0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dtype)


for dtype, cases in ((torch.float32, [(197, 12, 64, None), (577, 12, 64, 500), (300, 16, 32, None)]),
                     (torch.bfloat16, [(577, 12, 64, None), (577, 16, 32, 500),
                                       (1025, 12, 64, None)])):
    f32 = dtype == torch.float32
    for i, (n, h, hd, valid_len) in enumerate(cases):
        b, d = (4 if n > 1024 else 8), h * hd
        tag = f"{dtype} N={n} H={h} hd={hd} valid_len={valid_len}"
        qkv, bias = randn(i, b, n, 3 * d, dtype=dtype), randn(100 + i, 3 * d, dtype=dtype, scale=0.5)
        dout = randn(200 + i, b, n, d, dtype=dtype)
        outputs[f"qkv_attention {tag}"] = qkv_attention._forward_kernel(
            qkv, h, f32 or i % 2 == 0, valid_len, bias)
        saved = {}
        if f32:
            out, lse = qkv_attention._forward_kernel(qkv, h, True, valid_len, bias, lse=True)
            outputs[f"qkv_attention lse {tag}"] = lse
            saved = dict(out=out, lse=lse)
        for scaled_ds in (False, True):
            dqkv, dbias = qkv_attention._backward_kernel(qkv, dout, h, f32 or i % 2 == 0,
                                                         valid_len, bias, scaled_ds=scaled_ds,
                                                         **saved)
            outputs[f"qkv_attention backward scaled_ds={scaled_ds} {tag}"] = dqkv
            outputs[f"qkv_attention dbias scaled_ds={scaled_ds} {tag}"] = dbias
        if n > 577 or (f32 and n != 197):
            continue
        w, b1 = randn(300 + i, d, d, dtype=dtype, scale=d ** -0.5), randn(400 + i, d, dtype=dtype)
        outputs[f"attn_proj {tag}"] = attn_proj._forward_kernel(qkv, w, b1, h, True, valid_len)
        for j, g in enumerate(attn_proj._backward_kernel(qkv, w, b1, dout, h, True, valid_len)):
            outputs[f"attn_proj backward {j} {tag}"] = g
        x = randn(500 + i, b, n, d, dtype=dtype)
        w3 = randn(600 + i, d, 3 * d, dtype=dtype, scale=d ** -0.5)
        outputs[f"qkvproj_attention {tag}"] = attention_block._forward_kernel(
            x, w3, bias, h, True, valid_len)
        for j, g in enumerate(attention_block._backward_kernel(x, w3, bias, dout, h, True,
                                                               valid_len)):
            outputs[f"qkvproj_attention backward {j} {tag}"] = g
torch.cuda.synchronize()
torch.save({k: v.cpu() for k, v in outputs.items()}, sys.argv[1])
"""


def build(root: Path) -> Path:
    """The checkout's kernel library, built by its own ``_build``."""
    code = ("from ssl4polyp_tpu_torch.ops import _build; _build.library(); "
            "print(_build.library_path())")
    done = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"building {root} failed:\n{done.stdout}{done.stderr}")
    return Path(done.stdout.strip().splitlines()[-1])


def wrapper_outputs(root: Path, path: Path) -> dict:
    """WRAPPER_OUTPUTS run in the checkout at ``root``, its tensors."""
    done = subprocess.run([sys.executable, "-c", WRAPPER_OUTPUTS, str(path)], cwd=root,
                          capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"the wrappers of {root} failed:\n{done.stdout}{done.stderr}")
    return torch.load(path)


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
    with tempfile.TemporaryDirectory() as tmp:
        other = wrapper_outputs(args.other.resolve(), Path(tmp) / "other.pt")
        this = wrapper_outputs(ROOT, Path(tmp) / "this.pt")
    if other.keys() != this.keys():
        raise SystemExit("the two checkouts' wrappers gave different outputs to compare")
    differing = [name for name in this if not torch.equal(this[name], other[name])]
    same &= not differing
    print(f"wrappers: {len(this) - len(differing)} of {len(this)} outputs bit-equal"
          + (f"; differing: {differing}" if differing else ""))
    print(json.dumps({"card": card, "cases": rows, "wrapper_outputs": len(this),
                      "wrapper_outputs_differing": differing}))
    if not same:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
