"""B4, B5 and B6: fused wire encode, decode/apply and hit count
(``csrc/wire_pack.cu``).

Replace the Pallas TPU kernels ``repro.kernels.wire_pack.wire_pack``,
``wire_unpack_add`` / ``wire_unpack`` and ``wire_nnz``. Encode reads the
filtered leaf once and writes the packed mask, the quantized values (dense
and compacted), the compacted flat indices, the count and the
error-feedback residual; decode reads the mask and the compacted values
and adds them into the target; the hit count reads a leaf once and writes
one int32. All passes stream, so the card's memory rate bounds them.

Encode and decode are one launch each: a single-pass compaction whose
tiles find their offsets by decoupled look-back through a buffer of
status words kept here per (device, stream) (``Lookback``), zeroed once
when it is made or grows, never per call.

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it runs
the plain version in ``kernels.ref``.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.kernels import build, ref

PACK = "wire_pack"
UNPACK_ADD = "wire_unpack_add"
NNZ = "wire_nnz"

CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
         torch.int32: 3}

# the B4/B5 tile of csrc/wire_pack.cu (its constexprs of the same names)
THREADS = 256  # kThreads
ITEMS = 16  # kItems: elements a thread
TILE = THREADS * ITEMS  # kTile: elements a block
STATUS_BASE = 1  # kStatusBase: word 0 is the ticket counter
SEQ_SHIFT = 32  # kSeqShift: a status word is (seq << 32) | flag | count
INCLUSIVE = 1 << 31  # kInclusive: the word's count is a prefix
MAX_ELEMENTS = 2**31 - 1  # kMaxElements: counts fit 31 bits
SEQ_LIMIT = 2**32 - 1  # the last sequence number a buffer takes


def tiles(n: int) -> int:
    """Blocks (tiles) of one B4 or B5 call on ``n`` elements."""
    return -(-n // TILE)


class Lookback:
    """The look-back buffers of B4 and B5, one per (device, stream): int64
    words, the ticket counter then one status word a tile, zeroed when a
    buffer is made or grows (doubling) and never reset per call. Each call
    takes the buffer's next sequence number (1, 2, ...); after
    ``SEQ_LIMIT`` the next call gets a fresh zeroed buffer, and every new
    buffer starts again at 1. Calls on one stream run in order, so they
    share a buffer; the kernel sets the counter back to 0 itself."""

    def __init__(self):
        self._bufs: dict = {}
        self._lock = threading.Lock()

    def take(self, device: torch.device, stream: int, ntiles: int):
        """``(words, seq)`` for one call of ``ntiles`` tiles."""
        key = (str(device), stream)
        with self._lock:
            words, seq = self._bufs.get(key, (None, 0))
            need = STATUS_BASE + ntiles
            if words is None or words.numel() < need or seq >= SEQ_LIMIT:
                size = need if words is None else max(need, 2 * words.numel())
                words, seq = torch.zeros(size, dtype=torch.int64,
                                         device=device), 0
            seq += 1
            self._bufs[key] = (words, seq)
            return words, seq


LOOKBACK = Lookback()


def _lookback(dev: torch.device, n: int, kernel: str):
    if n > MAX_ELEMENTS:
        raise ValueError(f"{kernel}: {n} elements, at most {MAX_ELEMENTS}")
    if torch.cuda.is_current_stream_capturing():
        # a captured call would replay its sequence number
        raise RuntimeError(f"{kernel}: cannot be captured in a CUDA graph")
    stream = build.stream_ptr(dev)
    words, seq = LOOKBACK.take(dev, stream, tiles(n))
    return words, seq, stream


def wire_pack(flat: torch.Tensor, vdt: torch.dtype):
    """Encode one flat leaf (n >= 1):
    ``(mask_bytes, qdense, cvals, cidx, nnz, residual)``.

    ``mask_bytes`` is uint8[ceil(n/8)], little-endian; ``qdense`` every
    value in ``vdt``; ``cvals``/``cidx`` the significant values and their
    int32 flat indices, front-compacted (entries past ``nnz`` are not
    defined on the card and zero in the plain version); ``nnz`` a 0-d int32
    tensor; ``residual`` float32 ``f32(x) - f32(quant(x))``.
    """
    if flat.dim() != 1 or flat.numel() < 1:
        raise ValueError(f"{PACK}: expects a non-empty 1-D tensor")
    if flat.dtype not in CODES or vdt not in CODES:
        raise TypeError(f"{PACK}: unsupported types {flat.dtype} -> {vdt}")
    if (flat.dtype == torch.int32) != (vdt == torch.int32):
        raise TypeError(f"{PACK}: int32 leaves do not quantize")
    if flat.device.type == "cpu":
        return ref.wire_pack_ref(flat, vdt)
    build.require_cuda(flat, PACK)
    n, dev = flat.numel(), flat.device
    mask = torch.empty((n + 7) // 8, dtype=torch.uint8, device=dev)
    qdense = torch.empty(n, dtype=vdt, device=dev)
    cvals = torch.empty(n, dtype=vdt, device=dev)
    cidx = torch.empty(n, dtype=torch.int32, device=dev)
    residual = torch.empty(n, dtype=torch.float32, device=dev)
    nnz = torch.empty((), dtype=torch.int32, device=dev)
    words, seq, stream = _lookback(dev, n, PACK)
    lib = build.load("wire_pack")
    build.check(lib.wire_pack_launch(
        flat.data_ptr(), CODES[flat.dtype], CODES[vdt], n, mask.data_ptr(),
        qdense.data_ptr(), cvals.data_ptr(), cidx.data_ptr(),
        residual.data_ptr(), nnz.data_ptr(), words.data_ptr(), seq,
        stream), PACK)
    build.LAUNCHES[PACK] += 1
    return mask, qdense, cvals, cidx, nnz, residual


def _unpack(target, mask_bytes, cvals, n, dtype, accumulate):
    dev = mask_bytes.device
    for t, what in ((mask_bytes, "mask"), (cvals, "values")):
        build.require_cuda(t, f"{UNPACK_ADD} {what}")
        if t.device != dev:
            raise ValueError(f"{UNPACK_ADD}: tensors on {dev} and {t.device}")
    out = torch.empty(n, dtype=dtype, device=dev)
    if accumulate:
        build.require_cuda(target, f"{UNPACK_ADD} target")
        if target.device != dev:
            raise ValueError(f"{UNPACK_ADD}: target on {target.device}")
    words, seq, stream = _lookback(dev, n, UNPACK_ADD)
    lib = build.load("wire_pack")
    build.check(lib.wire_unpack_add_launch(
        (target if accumulate else out).data_ptr(), CODES[dtype],
        mask_bytes.data_ptr(), n, cvals.data_ptr(), cvals.numel(),
        CODES[cvals.dtype], out.data_ptr(), int(accumulate),
        words.data_ptr(), seq, stream), UNPACK_ADD)
    build.LAUNCHES[UNPACK_ADD] += 1
    return out


_HALVES = (torch.float16, torch.bfloat16)


def _check_unpack(mask_bytes, cvals, n, dtype, accumulate):
    if mask_bytes.dtype != torch.uint8 or mask_bytes.numel() != (n + 7) // 8:
        raise ValueError(f"{UNPACK_ADD}: mask must be uint8[ceil(n/8)]")
    ok = (dtype == torch.int32 and cvals.dtype == torch.int32) or (
        dtype == torch.float32 and cvals.dtype in (torch.float32, *_HALVES)
    ) or (not accumulate and dtype in _HALVES and cvals.dtype in _HALVES)
    if not ok:
        raise TypeError(f"{UNPACK_ADD}: unsupported types {cvals.dtype} -> "
                        f"{dtype} (float32 and int32 targets; float16 and "
                        f"bfloat16 only to decode)")


def wire_unpack_add(
    target: torch.Tensor, mask_bytes: torch.Tensor, cvals: torch.Tensor
) -> torch.Tensor:
    """``target + decode(mask_bytes, cvals)`` for a flat float32 or int32
    target; ``cvals`` holds the ``nnz`` significant values in flat order.
    Every element gets an add, ``+0`` off the support. With fewer values
    than set bits, a position past the last value reads the last value
    (and no values read as zeros), as JAX's gather clamps to the values'
    capacity."""
    if target.dim() != 1 or target.numel() < 1:
        raise ValueError(f"{UNPACK_ADD}: expects a non-empty 1-D target")
    _check_unpack(mask_bytes, cvals, target.numel(), target.dtype, True)
    if target.device.type == "cpu":
        return ref.wire_unpack_add_ref(target, mask_bytes, cvals)
    return _unpack(target, mask_bytes, cvals, target.numel(), target.dtype,
                   accumulate=True)


def wire_unpack(
    mask_bytes: torch.Tensor, cvals: torch.Tensor, n: int, dtype: torch.dtype
) -> torch.Tensor:
    """Decode only: the values on the support, exact zeros elsewhere.
    float32 and int32 targets as ``wire_unpack_add``, and float16 or
    bfloat16 targets from float16 or bfloat16 values (each value rounded
    once to the target's type; ``-0.0`` on the support is kept)."""
    _check_unpack(mask_bytes, cvals, n, dtype, False)
    if mask_bytes.device.type == "cpu":
        return ref.wire_unpack_ref(mask_bytes, cvals, n, dtype)
    return _unpack(None, mask_bytes, cvals, n, dtype, accumulate=False)


def wire_nnz(flat: torch.Tensor) -> torch.Tensor:
    """The nonzero count of a flat tensor as a 0-d int32 tensor on its
    device (``-0.0`` counts as zero, NaN as nonzero), exact at any length
    below 2**31. float32, float16, bfloat16 or int32. On a CUDA tensor this
    launches the kernel (none for an empty tensor); on a CPU tensor it runs
    the plain version."""
    if flat.dim() != 1:
        raise ValueError(f"{NNZ}: expects a 1-D tensor")
    if flat.dtype not in CODES:
        raise TypeError(f"{NNZ}: unsupported type {flat.dtype}")
    if flat.numel() >= 2**31:
        raise ValueError(f"{NNZ}: {flat.numel()} elements overflow int32")
    if flat.device.type == "cpu":
        return ref.wire_nnz_ref(flat)
    build.require_cuda(flat, NNZ)
    out = torch.zeros((), dtype=torch.int32, device=flat.device)
    if flat.numel():
        lib = build.load("wire_pack")
        build.check(lib.wire_nnz_launch(
            flat.data_ptr(), CODES[flat.dtype], flat.numel(), out.data_ptr(),
            build.stream_ptr(flat.device)), NNZ)
        build.LAUNCHES[NNZ] += 1
    return out
