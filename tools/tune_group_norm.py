"""Time K4 (GroupNorm + SiLU, `csrc/group_norm.cu`) under every plan its two
regimes allow, at the GroupNorm shapes of the SDXL UNet and VAE decoder
(`chip_smoke.GN_UNET_CALL`, `chip_smoke.GN_VAE_DECODE`), bf16, on one CUDA
card: the evidence behind `plan_group_norm`'s constants.

    python3 tools/tune_group_norm.py [--threads 256:4,512:2] [--out DIR]

For each (threads a CTA, CTAs an SM) pair given, it builds a copy of the
kernel with those constants into `build/` (one nvcc each, all at once). For
each shape it then times, in device time (a CUDA graph of 20 calls,
`chip_smoke.graph_ms`), the cluster regime at every cluster size whose chunk
fits a CTA's shared memory and the split regime at chunks of 16, 32, 64 and
128 KB, next to the plan `plan_group_norm` picks and `F.group_norm` +
`F.silu`. Every timed plan is first held to the plain version (one bf16 ulp
at the reference's largest magnitude). With `--out DIR` the rows also go to
`DIR/tune_group_norm.json`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (the repository root is on the path from here)


def build_variants(pairs):
    """{(threads, ctas_per_sm): ctypes library}, built from copies of the
    kernel source with those constants."""
    from diffusers_tpu_torch.ops.cuda import _build, group_norm as gn

    src = gn.SOURCE.read_text()
    procs = {}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for threads, ctas in pairs:
        text = re.sub(r"constexpr int kThreads = \d+;", f"constexpr int kThreads = {threads};", src)
        text = re.sub(r"constexpr int kMinBlocks = \d+;", f"constexpr int kMinBlocks = {ctas};", text)
        copy = gn.SOURCE.with_name(f"_tune_{threads}_{ctas}.cu")  # beside the source, for its header
        copy.write_text(text)
        lib = _build.BUILD_DIR / f"libgroup_norm_tune_{threads}_{ctas}.so"
        procs[(threads, ctas)] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(copy)],
                                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                                  lib, copy)
    libs = {}
    for key, (proc, lib, copy) in procs.items():
        log, _ = proc.communicate()
        copy.unlink()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log[-4000:]}")
        handle = ctypes.CDLL(str(lib))
        handle.group_norm_fwd.argtypes = gn.load_library().group_norm_fwd.argtypes
        handle.group_norm_fwd.restype = ctypes.c_int
        libs[key] = handle
        print(f"[build] threads {key[0]}, CTAs an SM {key[1]}: "
              f"{[(r[0], r[1]) for r in chip_smoke.ptxas_summary(log) if 'float' not in r[0]]}", flush=True)
    return libs


def candidate_plans(span: int, itemsize: int):
    from diffusers_tpu_torch.ops.cuda import group_norm as gn

    align = 16 // itemsize
    plans = []
    for n in (1, 2, 4, 8):
        chunk = gn._ceil(gn._ceil(span, n), align) * align
        if gn.smem_bytes(chunk, itemsize) <= gn.MAX_SMEM:
            plans.append(gn.GroupNormPlan(False, n, chunk, gn.smem_bytes(chunk, itemsize)))
    for kb in (16, 32, 64, 128):
        chunk = kb * 1024 // itemsize
        if chunk < span:
            plans.append(gn.GroupNormPlan(True, gn._ceil(span, chunk), chunk, gn.smem_bytes(chunk, itemsize)))
    return plans


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--threads", default="256:4,512:2", help="threads:ctas_per_sm pairs to build")
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("tune_group_norm: needs a CUDA card")
    from diffusers_tpu_torch.ops.cuda import _build, group_norm as gn

    pairs = [tuple(int(v) for v in p.split(":")) for p in args.threads.split(",")]
    libs = build_variants(pairs)
    dev = torch.device("cuda", 0)
    sms = _build.sm_count(0)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    rows = []
    shapes = list(dict.fromkeys(shape for shape, _, _ in chip_smoke.GN_UNET_CALL + chip_smoke.GN_VAE_DECODE))
    for shape in shapes:
        c = shape[1]
        x = (torch.randn(shape, generator=gen, device=dev) * 1.5 + 0.5).to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        b = (0.1 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        ref = gn.group_norm_plain(x.float(), w.float(), b.float(), 32, 1e-6, apply_silu=True)
        tol = chip_smoke.bf16_tol(ref)
        hw = x[0, 0].numel()
        span = c // 32 * hw
        bound = 2 * x.numel() * x.element_size() / chip_smoke.PEAK_BYTES * 1e3
        library = chip_smoke.graph_ms(lambda: F.silu(F.group_norm(x, 32, w, b, 1e-6)))
        picked = gn.plan_group_norm(tuple(shape), torch.bfloat16, sms)
        print(f"{tuple(shape)}: bound {bound:.4f} ms, F.group_norm+F.silu {library:.4f} ms, plan_group_norm "
              f"{picked}", flush=True)
        for key, lib in libs.items():
            for plan in candidate_plans(span, 2):
                y = torch.empty_like(x)
                ws = torch.empty(shape[0] * 32 * plan.parts * 2, device=dev) if plan.split else None

                def call():
                    err = lib.group_norm_fwd(
                        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                        ws.data_ptr() if ws is not None else None,
                        shape[0] * 32, 32, c // 32, hw, *gn.fast_divisor(hw), 0, 0, int(plan.split), plan.parts,
                        plan.chunk, 1e-6, 1, -1, _build.stream_of(dev))
                    if err:
                        raise RuntimeError(f"launch failed with cudaError_t {err}: {plan}")

                call()
                torch.cuda.synchronize()
                ok = float((y.float() - ref).abs().max()) <= tol
                ms = chip_smoke.graph_ms(call)
                row = {"shape": list(shape), "threads": key[0], "ctas_per_sm": key[1], "split": plan.split,
                       "parts": plan.parts, "chunk_kb": plan.chunk * 2 / 1024, "device_ms": ms, "bound_ms": bound,
                       "share_of_bound": bound / ms, "library_device_ms": library, "within_tol": ok,
                       "picked": plan == picked}
                rows.append(row)
                print(f"  threads {key[0]}:{key[1]} {'split' if plan.split else 'cluster'} parts {plan.parts} chunk "
                      f"{row['chunk_kb']:.0f} KB: {ms:.4f} ms ({100 * bound / ms:.0f}% of the bound)"
                      f"{' <- plan' if row['picked'] else ''}{'' if ok else ' OUTSIDE THE TOLERANCE'}", flush=True)
                if not ok:
                    return 1
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "tune_group_norm.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
