"""Launch plumbing shared by the kernel wrappers: the ctypes call, its error
check and the launch counters; for the dual-component kernels also their
operand checks, their per-pack launch arguments (built once) and their
scratch (one allocation a call).

Every wrapper counts its own launches here (``launch_counts()``), bumped
exactly where it calls its CUDA entry and nowhere else, so a run can show
which kernels its main path went through. A captured step graph
(``launch/step_graph.py``) takes its capture's counts back and adds them
once per replay (``add_launch_counts``), since a replay runs no wrapper.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from repro_torch.kernels.build import load

__all__ = ["add_counts", "add_launch_counts", "device_operand", "dual_args", "launch_counts",
           "reset_launch_counts", "launch_dual", "pack_args", "run_kernel", "scratch_layout"]

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


def add_launch_counts(delta: dict[str, int]) -> None:
    """Add ``delta`` (launches per wrapper name, negative to take some back)
    to the launch counts; a name whose count reaches 0 is dropped."""
    add_counts(_counts, delta)


def add_counts(counts: dict[str, int], delta: dict[str, int]) -> None:
    """``counts += delta`` per key, in place, dropping keys that reach 0."""
    for k, v in delta.items():
        n = counts.get(k, 0) + v
        if n:
            counts[k] = n
        else:
            counts.pop(k, None)


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
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index is None or device.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, stream)
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


def _check_pack(gw, kind: str) -> None:
    from repro_torch.kernels.contracts import ContractError

    if not 2 <= gw.a_bits <= 8:
        raise ContractError(f"[{kind}] a_bits={gw.a_bits} outside the int8 range [2, 8]")
    dev = gw.up.device
    for t in (gw.up, gw.us, gw.rp, gw.rs, *gw.vps, *gw.vss):
        if t.device != dev:
            raise ContractError(f"[{kind}] pack tensors on {t.device} and {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ContractError(f"[{kind}] pack tensors must be contiguous and 16-byte aligned")
    for t in (gw.us, gw.rs, *gw.vss):
        if t.dtype != torch.float32:
            raise ContractError(f"[{kind}] scales must be float32, got {t.dtype}")


class _PackArgs:
    """What a dual launch needs of one pack, built once: the fused group's
    checks, the segment table and pointer arrays as ctypes objects, and the
    constant leading arguments. Holds no tensor, so it keeps no pack alive."""

    def __init__(self, w, kind: str):
        gw = _group_of(w)
        _check_pack(gw, kind)
        self.device = gw.up.device
        self.n, self.r, self.group, self.a_bits = gw.ndim_out, gw.rank, gw.group, gw.a_bits
        self.hs_cols = sum(rj // gr for rj, gr in zip(gw.seg_r, gw.rgroups))
        info = []
        for no, nj, ro, rj, gr in zip(gw.n_offsets, gw.seg_n, gw.r_offsets, gw.seg_r,
                                      gw.rgroups):
            info += [no, nj, ro, rj, gr]
        ns = gw.n_segments
        # kept alive here: the C entry reads them through the pointers below
        self._info = (ctypes.c_longlong * len(info))(*info)
        self._vps = (ctypes.c_void_p * ns)(*[t.data_ptr() for t in gw.vps])
        self._vss = (ctypes.c_void_p * ns)(*[t.data_ptr() for t in gw.vss])
        self.head = [gw.up.data_ptr(), gw.us.data_ptr(), gw.rp.data_ptr(), gw.rs.data_ptr()]
        self.segs = [ns, ctypes.cast(self._info, _P), ctypes.cast(self._vps, _P),
                     ctypes.cast(self._vss, _P)]


def _group_of(w):
    from repro_torch.kernels.ref import TwinQuantGroupWeights, as_group

    return w if isinstance(w, TwinQuantGroupWeights) else as_group(w)


def _tensors(w) -> tuple:
    if hasattr(w, "vps"):
        return (w.up, w.us, w.rp, w.rs, *w.vps, *w.vss)
    return (w.up, w.us, w.rp, w.rs, w.vp, w.vs)


# (ids of a pack's tensors, its scalars) -> (weak references to the tensors,
# its _PackArgs). Keyed by the tensors, not by the pack object: the model's
# modules build a new pack object around the same buffers at every call.
_pack_args: dict[tuple, tuple] = {}


def pack_args(w, kind: str) -> _PackArgs:
    """The cached launch arguments of pack ``w`` (a single pack or a fused
    group): built once for a set of tensors (and a_bits / group sizes), and
    dropped when any of those tensors is freed. A pack's tensors must not be
    re-pointed in place (``set_``) while it is in use."""
    ts = _tensors(w)
    rgroups = w.rgroups if hasattr(w, "rgroups") else (w.rgroup,)
    key = (*map(id, ts), w.a_bits, w.group, rgroups)
    hit = _pack_args.get(key)
    if hit is not None and all(r() is t for r, t in zip(hit[0], ts)):
        return hit[1]
    args = _PackArgs(w, kind)

    def drop(_, k=key):
        _pack_args.pop(k, None)

    _pack_args[key] = (tuple(weakref.ref(t, drop) for t in ts), args)
    return args


def _align(n: int) -> int:
    return (n + 255) // 256 * 256


def scratch_layout(m: int, k: int, pa: _PackArgs, h_planes: int) -> tuple[int, list[int]]:
    """Bytes of a dual launch's scratch and the offsets of its five buffers
    in it: xq (M, K) int8, xs (M, K/G) f32, H as ``h_planes`` (M, R) f32
    planes, hq (M, R) int8, hs (M, hs_cols) f32; each 256-byte aligned."""
    sizes = (m * k, m * (k // pa.group) * 4, h_planes * m * pa.r * 4, m * pa.r,
             m * pa.hs_cols * 4)
    offs, total = [], 0
    for b in sizes:
        offs.append(total)
        total += _align(b)
    return total, offs


def dual_args(x_ptr: int, m: int, k: int, pa: _PackArgs, scratch_ptr: int, offs,
              out_ptr: int) -> list:
    """The C entry's argument list (``_DUAL_ARGS``, without the stream)."""
    return [x_ptr, *pa.head, m, k, pa.n, pa.r, pa.group, pa.a_bits, *pa.segs,
            *(scratch_ptr + o for o in offs), out_ptr]


def launch_dual(name: str, lib_name: str, fn_name: str, x: torch.Tensor, w, *,
                h_planes: int = 1) -> torch.Tensor:
    """Run the dual-component CUDA entry ``fn_name`` of ``csrc/<lib_name>.cu``
    on x (M, K) bf16 and the pack ``w`` (single or fused); returns (M, sum N)
    bf16. ``h_planes`` is the number of (M, R) f32 planes the entry keeps of
    H (its per-group terms, or H itself). The pack's constant arguments are
    built once (:func:`pack_args`); the scratch is one allocation. Counts one
    launch under ``name``. Raises on a launch error."""
    from repro_torch.kernels.contracts import ContractError

    if x.dtype != torch.bfloat16 or x.ndim != 2:
        raise ContractError(f"[{name}] x must be a 2-D bf16 tensor, got {x.dtype} "
                            f"{tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ContractError(f"[{name}] the CUDA kernel needs a CUDA tensor, got {x.device}")
    pa = pack_args(w, name)
    if x.device != pa.device:
        raise ContractError(f"[{name}] pack tensor on {pa.device}, activation on {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.contiguous().clone()
    m, k = x.shape
    total, offs = scratch_layout(m, k, pa, h_planes)
    scratch = torch.empty(total, dtype=torch.uint8, device=x.device)
    out = torch.empty((m, pa.n), dtype=torch.bfloat16, device=x.device)
    args = dual_args(x.data_ptr(), m, k, pa, scratch.data_ptr(), offs, out.data_ptr())
    run_kernel(name, lib_name, fn_name, _DUAL_ARGS, args, x.device)
    return out
