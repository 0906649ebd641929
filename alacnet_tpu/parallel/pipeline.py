"""Host->device decode orchestration: bucketing, padding, dispatch.

Stage structure (SURVEY.md §2.5 "PP"): stage 1 slices coded frames and
parses headers on the host (codec/framemeta.py), stage 2 runs the fused
batched decode on device (ops/frame_decode.py), stage 3 trims and formats
PCM on the host (pcm.py).  Batch and word-width are padded to a small set
of buckets so arbitrary workloads reuse a handful of XLA executables.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..codec.cookie import CodecParams
from ..codec.framemeta import FrameBatch
from ..codec.framemeta_vec import parse_frame_headers_vec as parse_frame_headers
from ..ops.frame_decode import FrameMetaArrays, decode_frames_packed

#: Lane-count buckets; larger batches round up to multiples of the last.
BATCH_BUCKETS = (8, 64, 256, 1024, 2048, 3072, 4096)
#: Word-width rounding (uint32 words; 256 words = 1 KiB payload).
WORD_BUCKET = 256


def _round_batch(b: int) -> int:
    for s in BATCH_BUCKETS:
        if b <= s:
            return s
    return -(-b // BATCH_BUCKETS[-1]) * BATCH_BUCKETS[-1]


def _pad_axis0(a: np.ndarray, b: int) -> np.ndarray:
    if a.shape[0] == b:
        return a
    pad = [(0, b - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


def pad_frame_batch(fb: FrameBatch, batch: int | None = None) -> FrameBatch:
    """Pad lanes to a bucketed batch size; padded lanes have n_samples=0."""
    b = _round_batch(fb.batch) if batch is None else batch
    w = -(-fb.words.shape[1] // WORD_BUCKET) * WORD_BUCKET
    if b == fb.batch and w == fb.words.shape[1]:
        return fb  # already bucket-aligned (blob parse packs to WORD_BUCKET)
    words = np.zeros((b, w), dtype=np.uint32)
    words[: fb.batch, : fb.words.shape[1]] = fb.words
    fields = {"words": words}
    for f in dataclasses.fields(fb):
        if f.name == "words":
            continue
        fields[f.name] = _pad_axis0(getattr(fb, f.name), b)
    return FrameBatch(**fields)


#: Static max_order values a span's FIR bound rounds up to (ordered):
#: every distinct value is a separate executable, so a short ladder
#: bounds compiles while keeping the kernel's FIR/adaptive walk tight.
_ORDER_BUCKETS = (0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 30)
#: Order 31 = pure integration (AlacFile.cs:283-292): no FIR window, no
#: adaptive walk — contributes 0 to a span's static max_order.
MAX_ORDER_SENTINEL = 31
#: Device words one span may hold (its (B, W) word table plus the
#: kernel's (2, S, B) staging and the (B, S, 2) output): spans of fat
#: frames get fewer lanes so a dispatch stays a bounded slice of the
#: card's memory.
SPAN_WORDS_BUDGET = 1 << 29


def _order_bucket(order: int) -> int:
    return next(b for b in _ORDER_BUCKETS if b >= order)


def span_max_order(fb: FrameBatch) -> int:
    """Static FIR bound for a batch: its deepest non-31 order, rounded up
    the ladder."""
    orders = fb.order[fb.order != MAX_ORDER_SENTINEL]
    return _order_bucket(int(orders.max()) if orders.size else 0)


def dispatch_frame_batch(
    fb: FrameBatch, max_samples: int, mesh=None, device_rows=None,
):
    """Parse-side dispatch: returns device arrays without synchronizing.

    JAX dispatch is asynchronous, so the caller can keep parsing the next
    batch on the host while the device decodes this one (the host->device
    pipeline stage overlap, SURVEY.md §2.5 "PP").

    ``mesh``: decode across a jax.sharding.Mesh — the lane axis shards
    over every device (DP, SURVEY.md §2.5) with host arrays placed
    straight onto their target shards.

    ``device_rows``: ``(bwords, ow, nbytes, W)`` from
    ``span_batch(idx, device_rows=True)`` + a device-resident
    ``blob_words`` blob — the word-row table is then gathered on the
    device (ops/pack_rows.py) instead of shipped from the host; fb
    carries an empty (B, 0) words placeholder.  Under a mesh the blob is
    replicated and each shard gathers its own lanes' rows
    (mesh.decode_frames_spmd_rows).
    """
    import jax

    from ..config import DEFAULT
    from ..ops.route import decode_route

    orig_b = fb.batch
    fb = pad_frame_batch(fb)
    platform = jax.default_backend()
    if mesh is not None:
        n_shards = mesh.devices.size
        platform = mesh.devices.flat[0].platform
        if fb.batch % n_shards:
            fb = pad_frame_batch(
                fb, -(-fb.batch // n_shards) * n_shards
            )
    kw = dict(
        route=decode_route(platform),
        max_order=span_max_order(fb),
        emit16=DEFAULT.emit16 and bool((fb.sample_size == 16).all()),
    )
    if mesh is not None:
        from .mesh import (
            decode_frames_spmd, decode_frames_spmd_rows, shard_frame_batch,
        )

        if device_rows is not None:
            bwords, ow, nbytes, W = device_rows
            out, n = decode_frames_spmd_rows(
                bwords, _pad_axis0(ow, fb.batch),
                _pad_axis0(nbytes, fb.batch), W,
                FrameMetaArrays.pack_host(fb), mesh, max_samples, **kw,
            )
            return out, n, orig_b
        words, meta = shard_frame_batch(fb, mesh)
        out, n = decode_frames_spmd(words, meta, mesh, max_samples, **kw)
        return out, n, orig_b
    if device_rows is not None:
        from ..ops.pack_rows import pack_rows

        bwords, ow, nbytes, W = device_rows
        ow = _pad_axis0(ow, fb.batch)  # padded lanes: ow=0, nbytes=0
        nbytes = _pad_axis0(nbytes, fb.batch)
        words_dev = pack_rows(bwords, jnp.asarray(ow), jnp.asarray(nbytes), W)
    else:
        # Two H2D transfers per batch (words + one packed metadata
        # matrix): per-array transfer setup otherwise dominates.
        words_dev = jnp.asarray(fb.words)
    out, n = decode_frames_packed(
        words_dev, jnp.asarray(FrameMetaArrays.pack_host(fb)), max_samples,
        **kw,
    )
    return out, n, orig_b


def decode_frame_batch(fb: FrameBatch, max_samples: int) -> tuple[np.ndarray, np.ndarray]:
    """Decode a parsed FrameBatch -> (samples (B, S, 2) int32, n (B,))."""
    out, n, orig_b = dispatch_frame_batch(fb, max_samples)
    return np.asarray(out[:orig_b]), np.asarray(n[:orig_b])


def plan_blob_batches(
    blob: np.ndarray,
    offsets: np.ndarray,
    sizes: np.ndarray,
    params: list[CodecParams] | CodecParams,
    batch_limit: int,
    strict: bool,
):
    """Batch planning for blob decode: header pre-pass + lane ordering.

    Parses every frame's header once (native, no word packing — ~0.5
    us/frame), then orders lanes by three keys (SURVEY.md §2.5 "EP" —
    variant routing):

      1. **bit depth**: 16-bit frames cluster into their own spans so a
         pooled mixed-format decode still ships int16 for them (emit16
         halves their D2H; dispatch_frame_batch picks the dtype per
         batch);
      2. **coded size**: a span's word table is as wide as its widest
         frame, and neighbouring kernel lanes then read neighbouring,
         similarly sized rows;
      3. **order** (31 = pure integration counts as 0), within equal
         sizes: spans get a tight static max_order.

    Spans are cut at ``batch_limit`` lanes, and earlier where a span's
    lanes x (word width + 2 x samples) would pass SPAN_WORDS_BUDGET.

    Returns (perm, inv, spans, span_batch) where ``spans`` are
    [lo, hi) index ranges into ``perm`` and ``span_batch(perm[lo:hi])``
    assembles that batch (sliced pre-parsed headers + per-span native
    word packing).  Callers unsort outputs with ``inv``.
    """
    import dataclasses

    from ..codec.framemeta import FrameBatch
    from ..codec.framemeta_vec import parse_frame_headers_blob, words_width

    F = len(offsets)
    offsets = np.asarray(offsets)
    sizes = np.asarray(sizes)
    hdr = parse_frame_headers_blob(
        blob, offsets, sizes, params, strict=strict, pack_words=False
    )
    is_wide = hdr.sample_size != 16
    okey = np.where(hdr.order == MAX_ORDER_SENTINEL, 0, hdr.order).max(axis=1)
    perm = np.lexsort((okey, sizes, is_wide))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(F)
    wide_p = is_wide[perm]
    boundaries = sorted(
        {0, F} | set((np.flatnonzero(np.diff(wide_p)) + 1).tolist())
    )
    sizes_p = sizes[perm]
    # An explicit (hassize) count can claim anything; decode clamps it.
    max_s = int(np.clip(hdr.n_samples, 0, 1 << 16).max(initial=0))
    spans = []
    for b_lo, b_hi in zip(boundaries[:-1], boundaries[1:]):
        lo = b_lo
        while lo < b_hi:
            hi = min(lo + batch_limit, b_hi)
            # Sizes ascend within the group, so the last lane is the widest.
            per_lane = words_width(int(sizes_p[hi - 1]), WORD_BUCKET) + 4 * max_s
            hi = min(hi, lo + max(1, SPAN_WORDS_BUDGET // per_lane))
            spans.append((lo, hi))
            lo = hi
    hdr_fields = [
        f.name for f in dataclasses.fields(FrameBatch) if f.name != "words"
    ]

    def span_batch(idx: np.ndarray, device_rows: bool = False):
        """Assemble one batch: sliced pre-parsed headers + packed words.

        ``device_rows=True`` skips host word packing entirely and
        returns ``(fb, ow, nbytes, W)`` for the on-device row gather
        (ops/pack_rows.py): fb.words is an empty (B, 0) placeholder,
        and the parsed bit positions are bumped by the frame's sub-word
        byte shift (rows start at a word boundary).
        """
        from .. import native
        from ..ops.bitreader import pack_frames_to_words

        offs = np.ascontiguousarray(offsets[idx])
        szs = np.ascontiguousarray(sizes[idx])
        if device_rows:
            from ..ops.pack_rows import host_row_params

            ow, nbytes, bump = host_row_params(offs, szs)
            W = words_width(
                int(nbytes.max()) if len(nbytes) else 0, WORD_BUCKET
            )
            fields = {f: getattr(hdr, f)[idx] for f in hdr_fields}
            fields["payload_pos"] = fields["payload_pos"] + bump
            fields["entropy_pos"] = fields["entropy_pos"] + bump
            fb = FrameBatch(
                words=np.zeros((len(idx), 0), np.uint32), **fields
            )
            return fb, ow, nbytes, W
        nwords = words_width(int(szs.max()) if len(szs) else 0, WORD_BUCKET)
        words = native.pack_frames_native(blob, offs, szs, nwords)
        if words is None:
            words = pack_frames_to_words(
                [blob[o : o + s].tobytes() for o, s in zip(offs, szs)]
            )
            words = np.pad(words, ((0, 0), (0, nwords - words.shape[1])))
        return FrameBatch(
            words=words, **{f: getattr(hdr, f)[idx] for f in hdr_fields}
        )

    return perm, inv, spans, span_batch


def decode_blob(
    blob: np.ndarray,
    offsets: np.ndarray,
    sizes: np.ndarray,
    params: list[CodecParams] | CodecParams,
    max_samples: int,
    batch_limit: int | None = None,
    strict: bool | None = None,
    sink=None,
    mesh=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode frames addressed as (offset, size) into a raw byte blob.

    Preferred production path: frame packing and header parsing run in
    the native host runtime (alacnet_tpu/native.py) when available, with
    no per-frame Python objects.  Returns (samples, n, status) where
    ``status`` flags per-frame parse failures in lenient mode.

    ``mesh``: shard every batch's lane axis across a jax.sharding.Mesh
    (multi-device DP decode; see parallel/mesh.py).

    ``sink``: optional device-side consumer ``sink(out, n, orig_b)``
    called with each batch's *device* arrays (padded, size-bucket order)
    instead of materializing PCM on the host — the decode-to-device path
    for downstream JAX stages (and for benchmarking without the D2H
    transfer).  With a sink the returned samples/n are empty; ``status``
    is still per-frame in original order.
    """
    from ..config import DEFAULT
    from ..utils.observability import GLOBAL_STATS, trace_span

    if batch_limit is None:
        batch_limit = DEFAULT.batch_limit
    if strict is None:
        strict = DEFAULT.strict
    sizes = np.asarray(sizes)
    with trace_span("alac.host.parse", "host_seconds"):
        perm, inv, spans, span_batch = plan_blob_batches(
            blob, offsets, sizes, params, batch_limit, strict
        )
    # Device-side row assembly (ops/pack_rows.py): ship the raw blob
    # once and skip the host word packer.  Under a mesh the word blob
    # replicates across the devices (one broadcast per corpus) and each
    # shard gathers its own lanes' rows.
    devpack = DEFAULT.device_pack
    bwords = None
    if devpack:
        from ..codec.framemeta_vec import words_width
        from ..ops.pack_rows import blob_words

        # Widest row any span will gather: the fattest frame's bytes
        # plus its <=3-byte sub-word shift.  Sizing the blob padding to
        # it keeps every tail-frame window in bounds (a clipped window
        # re-bases the row and corrupts the decode).
        max_w = words_width(
            int(sizes.max()) + 3 if len(sizes) else 0, WORD_BUCKET
        )
        sharding = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            sharding = NamedSharding(mesh, PartitionSpec())
        bwords = blob_words(np.asarray(blob), max_w=max_w, sharding=sharding)
    outs, ns, sts = [], [], []
    # Bounded async pipeline: the device decodes batch k while the host
    # parses batch k+1 (dispatch is non-blocking; <=2 batches in flight).
    pending: list = []

    def drain_one():
        out_d, n_d, orig_b, frames, nbytes, status = pending.pop(0)
        if sink is not None:
            sink(out_d, n_d, orig_b)
            GLOBAL_STATS.record(frames=frames, coded_bytes=nbytes)
            sts.append(status)
            return
        with trace_span("alac.device.result_wait", "result_wait_seconds"):
            out = np.asarray(out_d[:orig_b])
            n = np.asarray(n_d[:orig_b])
        GLOBAL_STATS.record(
            frames=frames, samples=int(n.sum()), coded_bytes=nbytes
        )
        outs.append(out)
        ns.append(n)
        sts.append(status)

    for lo, hi in spans:
        idx = perm[lo:hi]
        rows = None
        with trace_span("alac.host.parse", "host_seconds"):
            if devpack:
                fb, ow, nb, W = span_batch(idx, device_rows=True)
                rows = (bwords, ow, nb, W)
            else:
                fb = span_batch(idx)
        out_d, n_d, orig_b = dispatch_frame_batch(
            fb, max_samples, mesh=mesh, device_rows=rows,
        )
        pending.append(
            (out_d, n_d, orig_b, hi - lo, int(sizes[idx].sum()),
             fb.status[: hi - lo])
        )
        if len(pending) >= 2:
            drain_one()
    while pending:
        drain_one()
    if sink is not None:
        status = (
            np.concatenate(sts)[inv] if sts else np.zeros(0, np.int32)
        )
        return (
            np.zeros((0, max_samples, 2), np.int32),
            np.zeros(0, np.int32),
            status,
        )
    if not outs:
        return (
            np.zeros((0, max_samples, 2), np.int32),
            np.zeros(0, np.int32),
            np.zeros(0, np.int32),
        )
    return (
        np.concatenate(outs)[inv],
        np.concatenate(ns)[inv],
        np.concatenate(sts)[inv],
    )


def decode_payloads(
    payloads: list[bytes],
    params: list[CodecParams] | CodecParams,
    max_samples: int,
    batch_limit: int = BATCH_BUCKETS[-1],
) -> tuple[np.ndarray, np.ndarray]:
    """Parse + decode coded frame payloads in bucketed device batches.

    Returns (samples (F, S, 2) int32, n (F,) int32) across all frames.
    """
    outs, ns = [], []
    for lo in range(0, len(payloads), batch_limit):
        chunk = payloads[lo : lo + batch_limit]
        p = params if isinstance(params, CodecParams) else params[lo : lo + batch_limit]
        fb = parse_frame_headers(chunk, p)
        out, n = decode_frame_batch(fb, max_samples)
        outs.append(out)
        ns.append(n)
    if not outs:
        return np.zeros((0, max_samples, 2), np.int32), np.zeros(0, np.int32)
    return np.concatenate(outs), np.concatenate(ns)
