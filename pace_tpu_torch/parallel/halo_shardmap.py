"""The halo exchange across ranks: frames over torch.distributed, then the
halo kernel on each rank's shards and what it received.

Port of ``pace_tpu.parallel.halo_shardmap``. Each rank owns a contiguous
block of ``k = S / n`` shards (``mesh.py``). The exchange runs the SAME
region ops as the single-process one (``halo_slabs.py``):

- the union of the source rectangles of an exchange's ops is, for each
  input field, its *frame*: a few thin strips near the shard edges;
- a rank receives the frames of the remote shards its own shards read, as
  a static schedule (:func:`build_plan`: the frames, the rounds of an edge
  colouring of the rank-to-rank needs and the re-based tables of
  ``pace_tpu``'s ``build_plan``); every send and receive of an exchange is
  issued at once with ``batch_isend_irecv``;
- the received frames are laid into shard planes after the rank's own
  shards, and the exchange's plan, with every source shard re-based onto
  that local source (own shard ``j``, received slot ``k + i``), runs the
  halo kernel (``csrc/halo.cu``, through ``halo_kernel.exchange``) for the
  rank's ``k`` shards. On the CPU that is its plain version.

Frame extraction and placement are plain tensor indexing (they are plain
``jnp`` in ``pace_tpu`` too). With one rank nothing is received and the
exchange is the single-process one, bit for bit.

The result equals the single-process exchange exactly: the same copies from
the same values (``tests/test_torch_mesh.py`` holds every stagger, kind,
fold and sync at layouts [1, 1] and [2, 2] over three ranks).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..utils.ranges import stage_range
from .halo_kernel import ExchangePlan, _lift
from .halo_kernel import exchange as _exchange
from .halo_slabs import SlabHalo


@dataclasses.dataclass(frozen=True)
class _FieldFrame:
    """The frame of one input field: the union of its source rectangles, as
    row-band x column-interval pieces, and each point's offset in it."""

    name: str
    shape: Tuple[int, int]
    pieces: Tuple[Tuple[int, int, int, int], ...]  # (r0, r1, c0, c1)
    offset_map: np.ndarray  # (ny, nx) offset in the frame, or -1
    length: int
    base: int  # offset of this field's frame in the packed frame


@dataclasses.dataclass(frozen=True)
class _Round:
    perm_pairs: Tuple[Tuple[int, int], ...]  # (source rank, destination rank)
    send_sel: np.ndarray  # (n_dev, m) local shard each source sends (pad 0)
    recv_slot: np.ndarray  # (n_dev, m) slot of each received frame (pad: the dump slot)


@dataclasses.dataclass(frozen=True)
class _OpPlan:
    dst_rect: Tuple[int, int, int, int]
    row_table: np.ndarray  # (n_dev, k): own shard j, or k + slot
    klass_table: np.ndarray  # (n_dev, k)


@dataclasses.dataclass(frozen=True)
class _OutPlan:
    name: str
    src_field: int  # index of the input it copies, -1 for a region-only output
    ops: Tuple[_OpPlan, ...]


@dataclasses.dataclass(frozen=True)
class _Plan:
    n_dev: int
    k: int
    fields: Tuple[_FieldFrame, ...]
    total_frame: int
    rounds: Tuple[_Round, ...]
    cache_slots: int  # real slots; the dump slot follows them
    outs: Tuple[_OutPlan, ...]


def _build_frame(name, shape, rects, base) -> _FieldFrame:
    ny, nx = shape
    mask = np.zeros((ny, nx), dtype=bool)
    for r0, r1, c0, c1 in rects:
        mask[r0:r1, c0:c1] = True
    pieces: List[Tuple[int, int, int, int]] = []
    offset_map = np.full((ny, nx), -1, dtype=np.int64)
    off = 0
    r = 0
    while r < ny:
        r2 = r + 1
        while r2 < ny and np.array_equal(mask[r2], mask[r]):
            r2 += 1
        row = mask[r]
        c = 0
        while c < nx:
            if row[c]:
                c2 = c + 1
                while c2 < nx and row[c2]:
                    c2 += 1
                pieces.append((r, r2, c, c2))
                n = (r2 - r) * (c2 - c)
                offset_map[r:r2, c:c2] = off + np.arange(n).reshape(r2 - r, c2 - c)
                off += n
                c = c2
            else:
                c += 1
        r = r2
    return _FieldFrame(name, shape, tuple(pieces), offset_map, off, base)


def build_plan(
    field_shapes: Sequence[Tuple[str, Tuple[int, int]]],
    outs: Sequence[Tuple[str, str, Sequence]],
    n_shards: int,
    n_dev: int,
) -> _Plan:
    """The static schedule of an exchange on ``n_dev`` ranks.

    ``field_shapes``: ``[(input name, (ny, nx))]``, in order; ``outs``:
    ``[(output name, source input name or None, [region ops])]``."""
    if n_shards % n_dev:
        raise ValueError(f"S={n_shards} not divisible by {n_dev} devices")
    k = n_shards // n_dev
    field_names = [f for f, _ in field_shapes]

    rects_by_field: Dict[str, List] = {f: [] for f in field_names}
    for _out, _src, ops in outs:
        for op in ops:
            for c in op.classes:
                rects_by_field[c.src_comp].append(c.src_rect)
    frames: List[_FieldFrame] = []
    base = 0
    for fname, shape in field_shapes:
        fr = _build_frame(fname, shape, rects_by_field[fname], base)
        frames.append(fr)
        base += fr.length

    # the remote shards each rank reads
    remote: List[List[int]] = [[] for _ in range(n_dev)]
    for _out, _src, ops in outs:
        for op in ops:
            for s in range(n_shards):
                src = int(op.perm[s])
                d = s // k
                if src // k != d and src not in remote[d]:
                    remote[d].append(src)
    for d in range(n_dev):
        remote[d].sort()
    slot = [{r: i for i, r in enumerate(remote[d])} for d in range(n_dev)]
    cache_slots = max((len(r) for r in remote), default=0)
    dump = cache_slots

    # rounds: an edge colouring of the rank-to-rank needs
    edges: Dict[Tuple[int, int], List[int]] = {}
    for d in range(n_dev):
        for r in remote[d]:
            edges.setdefault((r // k, d), []).append(r)
    rounds: List[_Round] = []
    remaining = dict(edges)
    while remaining:
        used_src: set = set()
        used_dst: set = set()
        round_edges = []
        for (e, d) in sorted(remaining):
            if e not in used_src and d not in used_dst:
                round_edges.append((e, d))
                used_src.add(e)
                used_dst.add(d)
        m = max(len(remaining[ed]) for ed in round_edges)
        send_sel = np.zeros((n_dev, m), dtype=np.int64)
        recv_slot = np.full((n_dev, m), dump, dtype=np.int64)
        for (e, d) in round_edges:
            shards = remaining.pop((e, d))
            for j, r in enumerate(shards):
                send_sel[e, j] = r - e * k
                recv_slot[d, j] = slot[d][r]
        rounds.append(_Round(tuple(round_edges), send_sel, recv_slot))

    out_plans: List[_OutPlan] = []
    for out_name, src_name, ops in outs:
        op_plans: List[_OpPlan] = []
        for op in ops:
            row_table = np.zeros((n_dev, k), dtype=np.int64)
            for s in range(n_shards):
                src = int(op.perm[s])
                d, j = s // k, s % k
                row_table[d, j] = src - d * k if src // k == d else k + slot[d][src]
            klass_table = np.asarray(op.klass_of_shard).reshape(n_dev, k)
            op_plans.append(_OpPlan(op.dst_rect, row_table, klass_table))
        src_field = field_names.index(src_name) if src_name is not None else -1
        out_plans.append(_OutPlan(out_name, src_field, tuple(op_plans)))

    return _Plan(n_dev, k, tuple(frames), base, tuple(rounds), cache_slots, tuple(out_plans))


@dataclasses.dataclass(eq=False)
class _RankExchange:
    """One exchange's schedule as one rank runs it."""

    plan: _Plan
    local: ExchangePlan  # the exchange plan re-based onto [own | received]
    frame_idx: Tuple[torch.Tensor, ...]  # per field: plane offsets in frame order
    sends: Tuple[Tuple[int, torch.Tensor], ...]  # (peer, own shards to send), on the device
    recvs: Tuple[Tuple[int, torch.Tensor], ...]  # (peer, slots to fill), on the device


def _rank_exchange(xplan: ExchangePlan, planes: Dict[str, Tuple[int, int]], n_shards: int,
                   n_dev: int, rank: int, device) -> _RankExchange:
    names = sorted(planes)
    outs = []
    for name, src, _shape in xplan.outputs:
        outs.append((name, src, [op for oname, op in xplan.ops if oname == name]))
    plan = build_plan([(n, planes[n]) for n in names], outs, n_shards, n_dev)
    k = plan.k
    # re-based ops: this rank's k destination shards, sources in [own | received]
    by_out = {o.name: iter(o.ops) for o in plan.outs}
    ops = []
    for oname, op in xplan.ops:
        op_plan = next(by_out[oname])
        ops.append((oname, dataclasses.replace(
            op, perm=op_plan.row_table[rank].astype(np.int32),
            klass_of_shard=op_plan.klass_table[rank].astype(np.int32))))
    local = ExchangePlan(outputs=xplan.outputs, ops=tuple(ops))
    frame_idx = []
    for fr in plan.fields:
        pos = np.flatnonzero(fr.offset_map.ravel() >= 0)
        idx = np.empty(fr.length, dtype=np.int64)
        idx[fr.offset_map.ravel()[pos]] = pos
        frame_idx.append(torch.from_numpy(idx).to(device))
    dump = plan.cache_slots
    sends, recvs = [], []
    for rnd in plan.rounds:
        for e, d in rnd.perm_pairs:
            n = int((rnd.recv_slot[d] != dump).sum())
            if e == rank:
                sends.append((d, torch.from_numpy(rnd.send_sel[e, :n].copy()).to(device)))
            if d == rank:
                recvs.append((e, torch.from_numpy(rnd.recv_slot[d, :n].copy()).to(device)))
    return _RankExchange(plan, local, tuple(frame_idx), tuple(sends), tuple(recvs))


class DistributedHalo(SlabHalo):
    """The exchanger over a mesh: :class:`~.halo_slabs.SlabHalo`'s methods,
    each running the single-process exchange plan on this rank's block of
    shards. Fields are ``(k, ..., Y, X)``. The plans are ``slabs``'s own."""

    def __init__(self, slabs, mesh):
        super().__init__(slabs.halo)
        self._scalar_ops, self._vector_ops = slabs._scalar_ops, slabs._vector_ops
        self._sync_ops, self._plans = slabs._sync_ops, slabs._plans
        self.mesh = mesh
        halo = slabs.halo
        self.n_halo, self.n_tile, self.nsy, self.nsx = halo.n_halo, halo.n_tile, halo.nsy, halo.nsx
        self.partitioner = halo.partitioner
        self.n_shards = mesh.k
        self._rank: Dict = {}

    # ------------------------------------------------------------------
    def _schedule(self, xplan, names, inputs):
        first = inputs[names[0]]
        key = (id(xplan), tuple(tuple(inputs[n].shape[-2:]) for n in names), first.device)
        rx = self._rank.get(key)
        if rx is None:
            planes = {n: tuple(inputs[n].shape[-2:]) for n in names}
            rx = self._rank[key] = _rank_exchange(
                xplan, planes, self.halo.n_shards, self.mesh.world_size,
                self.mesh.rank, first.device)
        return rx

    def _issue(self, inputs, xplan):
        """Issue every send and receive of one exchange; returns the
        function that completes it."""
        import torch.distributed as dist

        names = sorted(inputs)
        rx = self._schedule(xplan, names, inputs)
        k = rx.plan.k
        if not (rx.sends or rx.recvs):
            # nothing to receive (one rank): the exchange on the rank's shards
            return lambda: _exchange(inputs, rx.local, n_out=k)
        lead = tuple(inputs[names[0]].shape[:-2])
        arrays = {n: _lift(inputs[n]) for n in names}
        ref = arrays[names[0]]
        mesh = self.mesh
        K = ref.shape[1]
        frames = torch.cat(
            [arrays[n].reshape(k, K, -1)[:, :, idx] for n, idx in zip(names, rx.frame_idx)],
            dim=-1)
        comm_dev = torch.device("cpu") if mesh.host_staged else ref.device
        ops, bufs = [], []
        for peer, rows in rx.sends:
            ops.append(dist.P2POp(dist.isend, mesh.to_comm(frames[rows].contiguous()), peer))
        for peer, slots in rx.recvs:
            buf = torch.empty((len(slots), K, rx.plan.total_frame), dtype=ref.dtype,
                              device=comm_dev)
            ops.append(dist.P2POp(dist.irecv, buf, peer))
            bufs.append((slots, buf))
        work = dist.batch_isend_irecv(ops)

        def finish():
            for w in work:
                w.wait()
            got = torch.empty((rx.plan.cache_slots, K, rx.plan.total_frame),
                              dtype=ref.dtype, device=ref.device)
            for slots, buf in bufs:
                got[slots] = mesh.from_comm(buf)
            # the local source: the rank's shards, then a plane for each
            # received shard that holds its frame; the rest of such a plane
            # lies outside every source rectangle and is never read
            sources = {}
            for n, fr, idx in zip(names, rx.plan.fields, rx.frame_idx):
                a = arrays[n]
                src = torch.empty((k + rx.plan.cache_slots,) + tuple(a.shape[1:]),
                                  dtype=a.dtype, device=a.device)
                src[:k] = a
                src[k:].view(rx.plan.cache_slots, K, -1)[:, :, idx] = \
                    got[:, :, fr.base:fr.base + fr.length]
                sources[n] = src
            outs = _exchange(sources, rx.local, n_out=k)
            return {name: out.reshape(lead + tuple(out.shape[-2:])) for name, out in outs.items()}

        return finish

    def _start(self, inputs, xplan):
        with stage_range("HaloExchange"):
            finish = self._issue(inputs, xplan)

        def complete():
            with stage_range("HaloExchange"):
                return finish()

        return complete

    def _exchange(self, inputs, xplan):
        with stage_range("HaloExchange"):
            return self._issue(inputs, xplan)()
