"""The faults a run can have, planted in the program under the harness: the
tests hold that each comes out not correct, in one process and on ranks.

:func:`plant` patches the program in this process (with ``setattr``, or a
``monkeypatch.setattr``). On a mesh each rank plants the same fault, and a
fault that names shards names them in the whole cube's numbering, so that a
run on ranks and a run in one process carry the same fault.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch


def _block(n_local: int):
    """``(lo, n_shards)`` of the shards this process steps."""
    from pace_tpu_torch.parallel.mesh import get_shard_mesh

    mesh = get_shard_mesh()
    return (0, n_local) if mesh is None else (mesh.lo, mesh.n_shards)


def _replace_tensors(state, fn):
    return dataclasses.replace(state, **{
        f.name: fn(f.name, getattr(state, f.name)) for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)})


def plant(fault: str, setattr_=setattr) -> None:
    """Patch the program with ``fault``, one of:

    - ``state unchanged``: the dycore step returns its input;
    - ``half the shards left out``: the shards of the cube's first half are
      stepped, the others keep their input (every rank still steps, so the
      exchanges match);
    - ``exchange left out``: in one process the exchange leaves every ghost
      cell as it was; on ranks nothing passes between ranks, and a ghost
      cell that a shard of another rank fills reads one of its own rank's;
    - ``receive slots swapped``: on ranks, the program's schedule between
      ranks (``halo_shardmap.build_plan``) lays the first two frames one
      rank receives in one round into each other's slots;
    - ``answer altered``: 0.5 K added to one point of ``pt`` on the cube's
      last shard after each step;
    - ``rank 1 raises``: rank 1's second step raises."""
    from pace_tpu_torch.models.fv3 import dycore

    step = dycore.DynamicalCore.step_dynamics
    if fault == "state unchanged":
        setattr_(dycore.DynamicalCore, "step_dynamics", lambda self, s: s)
    elif fault == "half the shards left out":
        def half(self, s):
            out = step(self, s)
            lo, n = _block(s.u.shape[0])
            keep = max(0, min(s.u.shape[0], n // 2 - lo))

            def cut(name, t):
                new = getattr(out, name)
                if not isinstance(new, torch.Tensor):
                    return new
                return torch.cat([new[:keep], t[keep:]])
            return _replace_tensors(s, cut)
        setattr_(dycore.DynamicalCore, "step_dynamics", half)
    elif fault == "exchange left out":
        from pace_tpu_torch.parallel import halo_shardmap, halo_slabs

        def no_exchange(inputs, plan, n_out=None):
            first = inputs[sorted(inputs)[0]]
            return {name: (inputs[src].clone() if src is not None else
                           torch.zeros(first.shape[:-2] + tuple(shape), dtype=first.dtype,
                                       device=first.device))
                    for name, src, shape in plan.outputs}

        rank_exchange = halo_shardmap._rank_exchange

        def local_only(xplan, planes, n_shards, n_dev, rank, device):
            # nothing sent or received; a ghost cell that a remote shard
            # fills reads a shard of this rank's instead
            rx = rank_exchange(xplan, planes, n_shards, n_dev, rank, device)
            k = rx.plan.k
            ops = tuple((name, dataclasses.replace(op, perm=(op.perm % k).astype(op.perm.dtype)))
                        for name, op in rx.local.ops)
            local = dataclasses.replace(rx.local, ops=ops, maps={})
            return dataclasses.replace(rx, local=local, sends=(), recvs=())
        # a rank of several learns its world from the launcher's environment
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            setattr_(halo_shardmap, "_rank_exchange", local_only)
        else:
            setattr_(halo_slabs, "_exchange", no_exchange)
    elif fault == "receive slots swapped":
        from pace_tpu_torch.parallel import halo_shardmap

        build_plan = halo_shardmap.build_plan

        def swapped(*args, **kwargs):
            plan = build_plan(*args, **kwargs)
            rounds = list(plan.rounds)
            for i, rnd in enumerate(rounds):
                for d in range(rnd.recv_slot.shape[0]):
                    real = np.flatnonzero(rnd.recv_slot[d] != plan.cache_slots)
                    if len(real) >= 2:
                        slots = rnd.recv_slot.copy()
                        slots[d, real[:2]] = slots[d, real[1::-1]]
                        rounds[i] = dataclasses.replace(rnd, recv_slot=slots)
                        return dataclasses.replace(plan, rounds=tuple(rounds))
            return plan
        setattr_(halo_shardmap, "build_plan", swapped)
    elif fault == "answer altered":
        def altered(self, s):
            out = step(self, s)
            lo, n = _block(s.u.shape[0])
            g = n - 1 - lo
            if not 0 <= g < out.pt.shape[0]:
                return out
            pt = out.pt.clone()
            pt[g, pt.shape[1] // 2, 9, 9] += 0.5
            return dataclasses.replace(out, pt=pt)
        setattr_(dycore.DynamicalCore, "step_dynamics", altered)
    elif fault == "rank 1 raises":
        import torch.distributed as dist

        calls = []

        def raises(self, s):
            calls.append(1)
            if dist.get_rank() == 1 and len(calls) == 2:
                raise RuntimeError("a fault planted on rank 1")
            return step(self, s)
        setattr_(dycore.DynamicalCore, "step_dynamics", raises)
    else:
        raise ValueError(f"unknown fault {fault!r}")
