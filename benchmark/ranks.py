"""A cell on N cards: N ranks on one host, one card each, through the port's
mesh (``mesh_config.enabled``).

:func:`launch` is what ``run.py`` does for a cell whose ``chips`` is above
1: it starts ``python3 -m benchmark.ranks`` N times, with a rendezvous on a
free localhost port, rank ``r`` on ``cuda:r`` with NCCL (gloo on the CPU;
ranks never share a card). It polls them; the
first rank that exits with another code than 0 ends the others, and the run
has no result. When every rank has exited 0, it returns rank 0's result,
which rank 0 wrote to a file inside the checkout.

Each rank runs :func:`harness.run_cell` with a :class:`Ranks`, the few
collectives the harness takes besides the program's own: the window's
stop, which rank 0's clock decides; barriers; each rank's readings
gathered; and the check's gap parts combined over the ranks. The process
group has a timeout, so a rank left waiting on a dead one raises rather
than hangs.
"""

from __future__ import annotations

import datetime
import json
import os
import signal
import socket
import subprocess
import sys
import time
import traceback
from typing import Dict, List, Optional, Sequence

from . import registry

#: seconds a rank waits in one collective before the process group raises:
#: longer than the longest stretch one rank works alone (the reference's
#: steps in the check, building the driver)
TIMEOUT_S = 300
#: seconds the launcher gives a rank to end after SIGTERM before SIGKILL
_GRACE_S = 10.0


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def result_path(cell_name: str):
    """Where rank 0 writes its result for the launcher."""
    return registry.RUN_ROOT / f"{cell_name}.result.json"


def launch(cell_name: str, seed: int, seconds: float, trace_run: bool, chips: int,
           device: str = "cuda", shrink: Optional[dict] = None, t_start: Optional[float] = None,
           entry: Optional[Sequence[str]] = None) -> Optional[dict]:
    """Run the cell on ``chips`` ranks; rank 0's result, or None when a rank
    failed (the others ended). ``entry``: the command that starts a rank
    (default ``python3 -m benchmark.ranks``), given the job as its last
    argument; the tests start ranks with a fault planted."""
    t_start = time.perf_counter() if t_start is None else t_start
    result = result_path(cell_name)
    result.parent.mkdir(parents=True, exist_ok=True)
    result.unlink(missing_ok=True)
    job = {"cell": cell_name, "seed": seed, "seconds": seconds, "trace": bool(trace_run),
           "device": device, "shrink": shrink, "t_start": t_start}
    cmd = list(entry or [sys.executable, "-m", "benchmark.ranks"]) + [json.dumps(job)]
    port = _free_port()
    threads = max(1, (os.cpu_count() or 1) // chips)
    procs: List[subprocess.Popen] = []

    def end(*_):
        raise SystemExit(143)

    prev = signal.signal(signal.SIGTERM, end)
    try:
        for r in range(chips):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE=str(chips), RANK=str(r), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(chips))
            env.setdefault("OMP_NUM_THREADS", str(threads))
            # a rank's standard output goes to standard error: the launcher's
            # standard output holds the result line alone
            procs.append(subprocess.Popen(cmd, env=env, stdout=2, cwd=registry.ROOT))
        while True:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                print(f"[ranks] rank {bad[0][0]} exited with {bad[0][1]}: ending the others",
                      file=sys.stderr, flush=True)
                return None
            if all(c == 0 for c in codes):
                break
            time.sleep(0.1)
        return json.loads(result.read_text())
    finally:
        signal.signal(signal.SIGTERM, prev)
        _end(procs)


def _end(procs: List[subprocess.Popen]) -> None:
    """SIGTERM every rank still running, SIGKILL it after the grace, and wait
    for each."""
    live = [p for p in procs if p.poll() is None]
    for p in live:
        p.terminate()
    deadline = time.monotonic() + _GRACE_S
    for p in live:
        try:
            p.wait(max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


class Ranks:
    """This process's place among the run's ranks, and the collectives the
    harness takes over the process group the rank started, on the rank's
    device (its card under NCCL, the host under gloo)."""

    def __init__(self, rank: int, world: int, device):
        import torch

        self.rank, self.world = rank, world
        self.device = torch.device(device)

    def _tensor(self, values):
        import torch

        return torch.tensor(values, dtype=torch.float64, device=self.device)

    def barrier(self) -> None:
        """Returns once every rank has reached it. Under NCCL a collective
        only queues work on the card, so the host waits for its result."""
        import torch.distributed as dist

        t = self._tensor([0.0])
        dist.all_reduce(t)
        t.item()

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank."""
        import torch.distributed as dist

        t = self._tensor([1.0 if flag else 0.0])
        dist.broadcast(t, src=0)
        return bool(t.item())

    def gather(self, obj) -> list:
        """Every rank's ``obj`` (picklable), in rank order, on every rank."""
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def combine(self, parts: Dict) -> Dict:
        """``{name: check.Parts}`` combined over the ranks, in rank 0's order
        of names: the whole cube's parts. A name that a rank lacks, or whose
        parts combine otherwise there, reads as missing."""
        from . import check

        every = self.gather(parts)
        out = {}
        for name, first in every[0].items():
            got = [p.get(name, check.MISSING) for p in every]
            out[name] = (check.combine(got) if all(g.kind == first.kind for g in got)
                         else check.MISSING)
        return out


def rank_main(argv=None) -> int:
    """One rank of :func:`launch`'s run: the rank from the environment, the
    job from the last argument."""
    argv = sys.argv[1:] if argv is None else argv
    job = json.loads(argv[-1])
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])

    import torch
    import torch.distributed as dist

    device = torch.device(job["device"])
    backend = "gloo"
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if world > cards:
            print(f"{world} ranks and {cards} cards: a rank needs a card of its own",
                  file=sys.stderr, flush=True)
            return 1
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        backend = "nccl"
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        world_size=world, rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)

    from . import harness

    try:
        result = harness.run_cell(job["cell"], job["seed"], job["seconds"], job["trace"],
                                  device=device, shrink=job["shrink"], t_start=job["t_start"],
                                  ranks=Ranks(rank, world, device))
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        return 1
    found = harness.jax_modules()
    if found:
        print(f"rank {rank} loaded {found}: the benchmark measures the port alone",
              file=sys.stderr, flush=True)
        return 1
    if rank == 0:
        path = result_path(job["cell"])
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(result))
        os.replace(tmp, path)
    dist.destroy_process_group()
    return 0


def main() -> None:
    """``python3 -m benchmark.ranks <job>``: one rank, its exit code the
    process's."""
    code = rank_main()
    sys.stdout.flush()
    sys.stderr.flush()
    if code:
        # a rank that failed leaves without tearing its process group down:
        # a peer may be gone, and the launcher ends the others
        os._exit(code)


if __name__ == "__main__":
    main()
