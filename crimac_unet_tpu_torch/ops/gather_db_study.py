"""Where K1's time goes: variants of ``csrc/gather_db.cu`` timed on a card.

    python -m crimac_unet_tpu_torch.ops.gather_db_study

Builds, beside the kernel library, four variants of the gather_db source
made by substitution (each substitution must match), and times each at
the prediction main path's shape — a (1020, 1120, 4) bfloat16 slab, 25
patches of 256 x 256 on a 5 x 5 grid at stride 216 plus 7 pad patches,
the data rectangle (20, 1020, 20, 1020), bfloat16 out:

* ``kernel``: the source as it is;
* ``copy``: the transform replaced by the identity (same loads, stores,
  border and edge paths): the memory floor of this design;
* ``no_log``: the transform without its log10f;
* ``empty``: an empty kernel on the same grid: the launch floor.

Each time is the device's: the launches are queued behind a device-side
sleep that outlasts their enqueue, then timed with CUDA events.  The
synthetic slab is not the survey's; the main path's own numbers come
from ``chip_smoke.py`` phase 2.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import re
import subprocess

import torch

from . import cuda_lib

_TRANSFORM = "float d = __fmul_rn(10.0f, log10f(__fadd_rn(x, 1e-10f)));"
_SCRUB = "  if (!isfinite(x)) x = 0.0f;\n"


def _variants(src: str) -> dict:
    def sub(text, old, new):
        if old not in text:
            raise RuntimeError(f"gather_db.cu no longer holds {old!r}")
        return text.replace(old, new)

    empty_body = re.sub(r"(gather_db_kernel\([^)]*\)) \{.*?\n\}\n",
                        r"\1 {}\n", src, count=1, flags=re.S)
    if empty_body == src:
        raise RuntimeError("gather_db_kernel's body was not found")
    return {
        "kernel": src,
        "copy": sub(sub(src, _SCRUB, ""), _TRANSFORM,
                    "float d = x;\n  return d;"),
        "no_log": sub(src, _TRANSFORM,
                      "float d = __fmul_rn(10.0f, __fadd_rn(x, 1e-10f));"),
        "empty": empty_body,
    }


def build_variants() -> dict:
    """{variant: loaded library}, compiled in parallel."""
    out = cuda_lib.BUILD_DIR / "gather_db_study"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_lib._nvcc()
    procs = {}
    for name, text in _variants(
            (cuda_lib.CSRC / "gather_db.cu").read_text()).items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *cuda_lib.NVCC_FLAGS, "-shared", "-I", str(cuda_lib.CSRC),
             str(cu), "-o", str(out / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.crimac_gather_db.argtypes = [P, I, I, I, I, P, P, I, I, I, I, I,
                                         I, I, I, I, P, I, P]
        libs[name] = lib
    return libs


def device_us(fn, iters: int = 200) -> float:
    """Mean device time of ``fn`` (one launch) in us, the launches queued
    behind a 50 ms device-side sleep."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(0.05 * 2.0e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("gather_db_study needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    slab = torch.exp(torch.randn((1020, 1120, 4), generator=g) * 2 - 14).to(
        dev, torch.bfloat16)
    starts = [(r * 216, c * 216) for r in range(5) for c in range(5)]
    starts += [(0, 0)] * 7
    y0s = torch.tensor([a for a, _ in starts], dtype=torch.int32, device=dev)
    x0s = torch.tensor([b for _, b in starts], dtype=torch.int32, device=dev)
    out = torch.empty((32, 256, 256, 4), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    args = (slab.data_ptr(), 1, 1020, 1120, 4, y0s.data_ptr(),
            x0s.data_ptr(), 32, 256, 256, 1, 20, 1020, 20, 1020, 0,
            out.data_ptr(), 1, stream)
    libs = build_variants()
    times = {name: [] for name in libs}
    for _ in range(2):
        for name, lib in libs.items():
            times[name].append(device_us(
                lambda: cuda_lib.check(lib.crimac_gather_db(*args), name)))
    print(f"gather_db variants at the main path's shape "
          f"({torch.cuda.get_device_name(0)}), device us per launch, two "
          f"rounds:")
    for name, t in times.items():
        print(f"  {name:7s} {t[0]:8.3f} {t[1]:8.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
