"""Launch plans of the weight-streaming kernels (``csrc/stream_tile.cuh``).

A plan is ``aligned`` when the copy engine can take every box (one TMA
tensor copy a stream and stage: variant ``rb*-async``), else box rows hold
each k row from the 16-byte granule of its first element on, one 16-byte
vector wider than the tile (``lead``), filled by TMA boxes where a
stream's rows allow it and granule by granule by cp.async where not
(``rb*-rowcopy``), and the consumers read each row at its own offset.
"""
from __future__ import annotations

import dataclasses

STAGE_FLOATS = 8192   # floats a stage (32 KB)
STAGE_BYTES = 4 * STAGE_FLOATS
# per rows a block (Geo<RB> in stream_tile.cuh): stages in the ring, the
# widest column tile (8 columns a lane at 4 rows, else 4), and the floats
# of staged activations (kmax(rb) x rb)
NSTAGE = {4: 4, 8: 2, 16: 2}
BN = {4: 256, 8: 128, 16: 128}
XS_FLOATS = {4: 4096, 8: 8192, 16: 8192}
WAVE_EFFICIENCY = 0.9  # the split count stops at the first plan this full
MAX_SPLITS = 32       # most k splits a plan tries


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def rb_fits(rb: int, streams: int) -> bool:
    """A block of ``rb`` rows keeps its streams' [streams, rb, BN[rb]]
    float32 sums for its epilogue in the ring and the staging: at most 12
    streams at 16 rows, 24 at 8 and 36 at 4 (``stream::rb_fits``)."""
    return streams * rb * BN[rb] <= NSTAGE[rb] * STAGE_FLOATS + XS_FLOATS[rb]


def row_block(rows: int, wd: int, n_slices: int = 1,
              streams: int = 1) -> int:
    """Rows a block owns: 4 for a decode round's <= 4 rows (and for codes
    of more than 24 streams), 8 up to 8 rows; beyond, 16 when the output
    has at least 16 column tiles of 128 (fewer row blocks stream the
    weights fewer times: granite's w1 at 64 rows) and the 16-row epilogue
    holds the streams, else 8 (more blocks to fill the card and to share
    the split reduction: wq, wk; T = 16)."""
    if rows <= 4 or not rb_fits(8, streams):
        return 4
    if rows <= 8 or n_slices * _cdiv(wd, 128) < 16 or \
            not rb_fits(16, streams):
        return 8
    return 16


def kmax(rb: int) -> int:
    """Deepest k range of one block with ``rb`` rows (its activations are
    staged in shared memory)."""
    return XS_FLOATS[rb] // rb


def box_elems(ks: int, pitch: int, elem: int = 4) -> int:
    """Elements of one stream's [ks, pitch] box in a stage, rounded up to
    128 bytes (the tensor copies' shared-memory alignment)."""
    q = 128 // elem
    return -(-ks * pitch // q) * q


def pitch_of(bn: int, elem: int = 4) -> int:
    """A box row: the tile width rounded up to whole 16-byte vectors."""
    v = 16 // elem
    return -(-bn // v) * v


def stage_rows(streams: int, pitch: int, elem: int = 4) -> int:
    """The most k rows a stage holds of each of ``streams`` boxes (at most
    256, the tensor copies' box limit)."""
    cap = STAGE_BYTES // elem
    ks = min(256, cap // (streams * pitch))
    while ks > 1 and streams * box_elems(ks, pitch, elem) > cap:
        ks -= 1
    return max(1, ks)


def tile_width(wd: int, aligned: bool, bn_max: int, elem: int = 4) -> int:
    """The widest tile that cuts a slice of ``wd`` columns into equal tiles
    of at most ``bn_max`` columns (whole 16-byte vectors on the copy
    engine's path)."""
    bn = _cdiv(wd, _cdiv(wd, bn_max))
    return min(bn_max, pitch_of(bn, elem)) if aligned else bn


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    rows: int
    k: int
    rb: int          # rows a block
    aligned: bool    # tensor copies (True), or row copies
    wd: int          # slice width; tiles never straddle a slice
    n_slices: int
    bn: int          # column tile width
    ks: int          # k rows a stage
    ksplit: int
    kchunk: int      # k rows a split
    elem: int = 4    # bytes of a stored weight: 4 float32, 2 bf16
    lead: int = 0    # elements a box row may start before its tile

    @property
    def nrb(self) -> int:
        return _cdiv(self.rows, self.rb)

    @property
    def tps(self) -> int:
        return _cdiv(self.wd, self.bn)

    @property
    def tiles(self) -> int:
        return self.n_slices * self.tps

    @property
    def counters(self) -> int:
        """Arrival counters the split reduction needs (one per tile and
        row block)."""
        return self.tiles * self.nrb

    @property
    def blocks(self) -> int:
        return self.counters * self.ksplit

    @property
    def pitch(self) -> int:
        """Elements of a box row in shared memory."""
        return pitch_of(self.bn, self.elem) + self.lead

    @property
    def variant(self) -> str:
        return (f"rb{self.rb}-{'async' if self.aligned else 'rowcopy'}"
                + ("-lead" if self.lead and self.aligned else "")
                + ("-bf16" if self.elem == 2 else ""))

    def units(self):
        """(c0, width, r0, kb0, kb1) of every block in launch order (row
        blocks fastest, then tiles, then splits): c0 the first column
        (slice-major), r0 the first row, [kb0, kb1) the k range."""
        out = []
        for u in range(self.blocks):
            rbi, rest = u % self.nrb, u // self.nrb
            tile, split = rest % self.tiles, rest // self.tiles
            s, o0 = tile // self.tps, (tile % self.tps) * self.bn
            kb0 = split * self.kchunk
            out.append((s * self.wd + o0, min(self.bn, self.wd - o0),
                        rbi * self.rb, kb0, min(self.k, kb0 + self.kchunk)))
        return out


def plan(rows: int, k: int, wd: int, n_slices: int, streams: int,
         slots: int, aligned: bool, elem: int = 4, lead: int = 0
         ) -> StreamPlan:
    """The plan for ``streams`` weight streams of ``n_slices`` slices of
    ``wd`` columns over k, stored in ``elem`` bytes an element, each box
    row ``lead`` elements wider than the tile (the copies of kernel 2's
    bf16 shards that start before their tile), on a card with ``slots``
    resident blocks (SMs x blocks per SM). k is split (each split at most
    kmax(rb) deep and a whole number of stages, each stage as deep as the
    split needs, at most as deep as a stage holds) until the blocks fill
    whole waves of the slots to WAVE_EFFICIENCY, or as near as MAX_SPLITS
    get. Row copies (not ``aligned``) take box rows a 16-byte vector wider
    than the tile whatever ``lead`` says: a row's granules start up to 15
    bytes before it."""
    if not aligned:
        lead = 16 // elem
    rb = row_block(rows, wd, n_slices, streams)
    # 256-column tiles only where they still give every slot work within
    # MAX_SPLITS (narrower than 128, row segments get short for DRAM), and
    # where a stage still holds 2 k rows of every stream (T = 16's 17-20
    # float32 streams would get one-row stages)
    bn = tile_width(wd, aligned, BN[rb] - lead, elem)
    if bn > 128 and (n_slices * _cdiv(wd, bn) * _cdiv(rows, rb) * MAX_SPLITS
                     < slots or stage_rows(streams, pitch_of(bn, elem) + lead,
                                           elem) < 2):
        bn = tile_width(wd, aligned, 128 - lead, elem)
    ks_max = stage_rows(streams, pitch_of(bn, elem) + lead, elem)
    base = n_slices * _cdiv(wd, bn) * _cdiv(rows, rb)
    kdeep = kmax(rb)
    nmax = max(_cdiv(k, kdeep), min(MAX_SPLITS, _cdiv(k, 2 * ks_max)))
    best, n = None, _cdiv(k, kdeep)
    while best is None or n <= nmax:
        # n splits of whole stages, each stage as deep as a split of this
        # depth needs (at most ks_max rows)
        kc = _cdiv(k, n)
        nst = _cdiv(kc, ks_max)
        ks = _cdiv(kc, nst)
        kchunk = nst * ks
        n += 1
        if kchunk > kdeep:
            continue
        ksplit = _cdiv(k, kchunk)
        u = base * ksplit
        eff = u / (_cdiv(u, slots) * slots)
        if best is None or eff > best[0] + 1e-9:
            best = (eff, ksplit, kchunk, ks)
        if eff >= WAVE_EFFICIENCY:
            break
    _, ksplit, kchunk, ks = best
    return StreamPlan(rows=rows, k=k, rb=rb, aligned=aligned, wd=wd,
                      n_slices=n_slices, bn=bn, ks=ks, ksplit=ksplit,
                      kchunk=kchunk, elem=elem, lead=lead)
