"""The accumulate step's window, and the seed before it, in one launch.

On CUDA tensors the accumulator (cluster/device_loop.py:
TorchDeviceAccumulator) takes its window through `WindowSelect`, which
launches csrc/window_select.cu; on CPU tensors it runs the kernel's plain
twin, `TorchDeviceAccumulator._window_ops` (after `_seed` in a seed step).
For the pool's flat positions (order, lens, key, tab, bin_start as
`ensure_ready` lays them out) and the loop state (alive, assign, astep,
members, msum):

    seed mode: the pool's first alive flat position leaves it and opens
        cluster cid at stamp stepc, alone in the member list, msum its row
        (zeros where the row lies outside the rows [lo, hi) that the counts
        hold); it is the center;
    the window of the center: the alive ranks into `crank`, the window's
        candidates into cand[:W] in flat order, and with `own` buffers the
        candidates whose rows lie in [lo, hi): their window positions and
        their rows less lo;
    the read, int64: (trip[0:3] or zeros, center, W, have, total), then the
        own candidates' count with `own`.

The wrapper resolves every buffer's pointer once (`__init__`, `bind`), so a
step's call passes only the center or the trip, or the seed's cid and
stepc: the host issues one ctypes call a step.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

_FIELDS = ("counts:p d size n nb order:p lens:p key:p tab:p bin_start:p crank:p cand:p "
           "alive:p assign:p astep:p members:p msum:p row_lo row_hi extras own_pos:p "
           "own_rows:p rd:p part:p device stream:p center:p trip:p seed cid stepc").split()


class _Args(ctypes.Structure):
    """csrc/window_select.cu's SelectArgs: every field 8 bytes wide."""
    _fields_ = [(f.split(":")[0], ctypes.c_void_p if f.endswith(":p") else ctypes.c_longlong)
                for f in _FIELDS]


def _lib():
    from ._build import load

    lib = load("window_select").lib
    if lib.mc2_window_select.argtypes is None:
        p = ctypes.c_void_p
        lib.mc2_window_select.argtypes = [p, p, p, ctypes.c_int, ctypes.c_longlong,
                                          ctypes.c_longlong]
        lib.mc2_window_select.restype = ctypes.c_int
        lib.mc2_window_select_part_len.argtypes = []
        lib.mc2_window_select_part_len.restype = ctypes.c_longlong
    return lib


def _want(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype} on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")


class WindowSelect:
    """csrc/window_select.cu over one pool's buffers on one card (module
    docstring).  `counts` holds the store rows [rows[0], rows[1]) (default:
    all of them, from 0); `own` = (own_pos, own_rows), int64 [n + 1], asks
    for the own candidates.  `bind` takes the loop state; `window` and
    `seed` launch on the stream current at `bind`, without syncing, and
    return `read`, a view of the read buffer that the next launch
    overwrites; `center` (int64 [1]) is the read's center, the seed's flat
    position after `seed`.  `launches` counts the launches of every
    instance."""

    launches = 0

    def __init__(self, counts: torch.Tensor, order, lens, key, tab, bin_start, crank, cand,
                 *, rows: Optional[Tuple[int, int]] = None,
                 own: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        dev = counts.device
        if dev.type != "cuda":
            raise ValueError(f"window_select runs on a CUDA device, got {dev}")
        if counts.dtype not in (torch.uint8, torch.uint16) or counts.dim() != 2 \
                or not counts.is_contiguous():
            raise ValueError("counts must be contiguous uint8/uint16 [rows, D]")
        n, nb = len(order), len(bin_start) - 1
        if n < 1 or nb < 1:
            raise ValueError(f"need a pool of at least one row and bin, got {n}, {nb}")
        i64 = torch.int64
        for name, t, shape in (("order", order, (n,)), ("lens", lens, (n,)), ("key", key, (n,)),
                               ("tab", tab, (n, 4)), ("bin_start", bin_start, (nb + 1,)),
                               ("crank", crank, (n + 1,)), ("cand", cand, (n + 1,))):
            _want(name, t, i64, shape, dev)
        if own is not None:
            for name, t in zip(("own_pos", "own_rows"), own):
                _want(name, t, i64, (n + 1,), dev)
        lib = _lib()
        lo, hi = rows if rows is not None else (0, counts.shape[0])
        self._rd = torch.zeros(8, dtype=i64, device=dev)
        self._part = torch.zeros(lib.mc2_window_select_part_len(), dtype=i64, device=dev)
        self.read = self._rd[:7 if own is None else 8]
        self.center = self._rd[3:4]
        self._keep = (counts, order, lens, key, tab, bin_start, crank, cand, own)
        self._args = _Args(
            counts=counts.data_ptr(), d=counts.shape[1], size=counts.element_size(), n=n,
            nb=nb, order=order.data_ptr(), lens=lens.data_ptr(), key=key.data_ptr(),
            tab=tab.data_ptr(), bin_start=bin_start.data_ptr(), crank=crank.data_ptr(),
            cand=cand.data_ptr(), row_lo=int(lo), row_hi=int(hi), extras=int(own is not None),
            own_pos=own[0].data_ptr() if own is not None else None,
            own_rows=own[1].data_ptr() if own is not None else None,
            rd=self._rd.data_ptr(), part=self._part.data_ptr(),
            device=dev.index if dev.index is not None else torch.cuda.current_device())
        self._addr = ctypes.addressof(self._args)
        self._fn = lib.mc2_window_select
        self._state = None

    def bind(self, alive, assign, astep, members, msum) -> None:
        """The loop state (StepState's tensors), updated in place by seeds;
        also takes the current stream."""
        counts = self._keep[0]
        dev, n = counts.device, self._args.n
        _want("alive", alive, torch.bool, (n,), dev)
        for name, t, shape in (("assign", assign, (n,)), ("astep", astep, (n,)),
                               ("members", members, (n + 1,)),
                               ("msum", msum, (counts.shape[1],))):
            _want(name, t, torch.int64, shape, dev)
        if alive.data_ptr() % 16:
            raise ValueError("alive must start on a 16-byte boundary")
        a = self._args
        a.alive, a.assign, a.astep, a.members, a.msum = (
            t.data_ptr() for t in (alive, assign, astep, members, msum))
        a.stream = torch.cuda.current_stream(dev).cuda_stream
        self._state = (alive, assign, astep, members, msum)

    def _launch(self, center: int, trip: int, seed: int, cid: int, stepc: int) -> torch.Tensor:
        if self._state is None:
            raise RuntimeError("window_select needs the loop state: call bind first")
        rc = self._fn(self._addr, center, trip, seed, cid, stepc)
        if rc != 0:
            raise RuntimeError(f"window_select kernel launch failed: cudaError {rc}")
        WindowSelect.launches += 1
        return self.read

    def window(self, center: int, trip: int = 0) -> torch.Tensor:
        """The window of the flat position at device address `center`
        (int64), with the read's first three entries from the trip at
        `trip` (0: zeros)."""
        return self._launch(center, trip, 0, 0, 0)

    def seed(self, cid: int, stepc: int) -> torch.Tensor:
        """The pool's first alive row opens cluster cid at stamp stepc; then
        its window.  The pool must not be empty."""
        return self._launch(0, 0, 1, cid, stepc)


def warm(counts: torch.Tensor) -> None:
    """Build and run the kernel once on a throwaway one-row pool of store
    row 0, in both modes, and wait for it."""
    dev = counts.device
    i64 = dict(dtype=torch.int64, device=dev)
    one = torch.ones(1, **i64)
    z = torch.zeros(1, **i64)
    sel = WindowSelect(counts, z, one, one, torch.tensor([[0, 2, 0, 0]], **i64),
                       torch.tensor([0, 1], **i64), torch.zeros(2, **i64), torch.zeros(2, **i64))
    sel.bind(torch.ones(1, dtype=torch.bool, device=dev), z - 1, z.clone(),
             torch.zeros(2, **i64), torch.zeros(counts.shape[1], **i64))
    sel.seed(0, 1)
    sel.window(sel.center.data_ptr())
    torch.cuda.synchronize(dev)
