"""Launch plumbing shared by the kernel wrappers: the ctypes call, its error
check and the launch counters; for the dual-component kernels also their
operand checks and scratch allocation.

Every wrapper counts its own launches here (``launch_counts()``), bumped
exactly where it calls its CUDA entry and nowhere else, so a run can show
which kernels its main path went through.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load

__all__ = ["device_operand", "launch_counts", "reset_launch_counts", "launch_dual", "run_kernel"]

_counts: dict[str, int] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
# (x, up, us, rp, rs, M, K, N, R, G, a_bits, n_seg, seg_info, vps, vss,
#  xq, xs, hf, hq, hs, out)
_DUAL_ARGS = [_P] * 5 + [_I] * 7 + [_P] * 9


def launch_counts() -> dict[str, int]:
    """Snapshot of kernel launches per wrapper name."""
    return dict(_counts)


def reset_launch_counts() -> None:
    """Zero every wrapper's launch count."""
    _counts.clear()


def _entry(lib_name: str, fn_name: str, argtypes):
    fn = getattr(load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes) + [_P]  # the stream last
        fn.restype = _I
    return fn


def run_kernel(name: str, lib_name: str, fn_name: str, argtypes, args,
               device: torch.device) -> None:
    """Call the C entry ``fn_name`` of ``csrc/<lib_name>.cu`` with ``args``
    (typed by ``argtypes``) and the current stream of ``device``; raise on
    a launch error, else count one launch under ``name``."""
    fn = _entry(lib_name, fn_name, argtypes)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"[{name}] CUDA launch failed: cudaError {rc}")
    _counts[name] = _counts.get(name, 0) + 1


def device_operand(kind: str, t: torch.Tensor, dtype, what: str, device: torch.device,
                   *, in_place: bool = False) -> torch.Tensor:
    """``t`` as a kernel reads it: on ``device`` and of ``dtype`` (else
    ContractError), contiguous and 16-byte aligned — copied if not, unless
    ``in_place`` (a buffer the kernel writes, or a page pool too large to
    copy quietly), which raises instead."""
    from repro_torch.kernels.contracts import ContractError

    if t.device != device:
        raise ContractError(f"[{kind}] {what} on {t.device}, the launch on {device}")
    if t.dtype != dtype:
        raise ContractError(f"[{kind}] {what} must be {dtype}, got {t.dtype}")
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    if in_place:
        raise ContractError(f"[{kind}] {what} must be contiguous and 16-byte aligned")
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_operands(x: torch.Tensor, gw, kind: str) -> None:
    from repro_torch.kernels.contracts import ContractError

    if x.dtype != torch.bfloat16 or x.ndim != 2:
        raise ContractError(f"[{kind}] x must be a 2-D bf16 tensor, got {x.dtype} "
                            f"{tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ContractError(f"[{kind}] the CUDA kernel needs a CUDA tensor, got {x.device}")
    if not 2 <= gw.a_bits <= 8:
        raise ContractError(f"[{kind}] a_bits={gw.a_bits} outside the int8 range [2, 8]")
    tensors = [gw.up, gw.us, gw.rp, gw.rs, *gw.vps, *gw.vss]
    for t in tensors:
        if t.device != x.device:
            raise ContractError(f"[{kind}] pack tensor on {t.device}, activation on {x.device}")
        if not t.is_contiguous():
            raise ContractError(f"[{kind}] pack tensors must be contiguous")
    for t in (gw.us, gw.rs, *gw.vss):
        if t.dtype != torch.float32:
            raise ContractError(f"[{kind}] scales must be float32, got {t.dtype}")


def launch_dual(name: str, lib_name: str, fn_name: str, x: torch.Tensor, gw) -> torch.Tensor:
    """Run the dual-component CUDA entry ``fn_name`` of ``csrc/<lib_name>.cu``
    on x (M, K) bf16 and the fused group ``gw``; returns (M, sum N) bf16.
    Counts one launch under ``name``. Raises on a launch error."""
    _check_operands(x, gw, name)
    x = x.contiguous()
    m, k = x.shape
    dev = x.device
    n, r, G = gw.ndim_out, gw.rank, gw.group
    hs_cols = sum(rj // gr for rj, gr in zip(gw.seg_r, gw.rgroups))
    xq = torch.empty((m, k), dtype=torch.int8, device=dev)
    xs = torch.empty((m, k // G), dtype=torch.float32, device=dev)
    hf = torch.empty((m, r), dtype=torch.float32, device=dev)
    hq = torch.empty((m, r), dtype=torch.int8, device=dev)
    hs = torch.empty((m, hs_cols), dtype=torch.float32, device=dev)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    ns = gw.n_segments
    info = []
    for no, nj, ro, rj, gr in zip(gw.n_offsets, gw.seg_n, gw.r_offsets, gw.seg_r, gw.rgroups):
        info += [no, nj, ro, rj, gr]
    seg_info = (ctypes.c_longlong * len(info))(*info)
    vps = (ctypes.c_void_p * ns)(*[t.data_ptr() for t in gw.vps])
    vss = (ctypes.c_void_p * ns)(*[t.data_ptr() for t in gw.vss])
    args = [
        x.data_ptr(), gw.up.data_ptr(), gw.us.data_ptr(), gw.rp.data_ptr(), gw.rs.data_ptr(),
        m, k, n, r, G, gw.a_bits, ns,
        ctypes.cast(seg_info, _P), ctypes.cast(vps, _P), ctypes.cast(vss, _P),
        xq.data_ptr(), xs.data_ptr(), hf.data_ptr(), hq.data_ptr(), hs.data_ptr(),
        out.data_ptr(),
    ]
    run_kernel(name, lib_name, fn_name, _DUAL_ARGS, args, dev)
    return out
