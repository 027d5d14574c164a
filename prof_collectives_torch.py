"""Which collectives gloo takes on CUDA tensors, and what they cost.

    python3 prof_collectives_torch.py

On the card's machine: two ranks share the one card over gloo (as
``chip_smoke.py`` [15] runs them).  Each collective the port could use
runs alone in a fresh pair of processes, on CUDA tensors, because an
unsupported one can abort its process (or one rank raises while the other
aborts).  Then the host
ms of ``all_reduce`` on CUDA tensors against the same reduction staged
through host memory by hand, and of ``all_gather`` on CPU tensors, at
64 B to 32 MiB; and NCCL at world 1.  Prints the card's name and power
limit and writes ``chiprun_out/prof_collectives.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
       "reduce_scatter_tensor", "barrier", "send_recv")
SIZES = (16, 1 << 16, 1 << 20, 1 << 23)        # float32 elements
REPS = 20
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")


def one_op(rank: int, world: int, store: str, op: str, out: str) -> None:
    """``op`` on a CUDA tensor over gloo; writes its checked value."""
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world,
                            rank=rank)
    dev = torch.device("cuda", 0)
    x = torch.full((1 << 16,), float(rank + 1), device=dev)
    if op == "all_reduce":
        dist.all_reduce(x)
        ok = float(x[0]) == 3.0
    elif op == "broadcast":
        dist.broadcast(x, 0)
        ok = float(x[0]) == 1.0
    elif op == "all_gather":
        ys = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(ys, x)
        ok = [float(y[0]) for y in ys] == [1.0, 2.0]
    elif op == "all_gather_into_tensor":
        big = torch.empty(world * x.numel(), device=dev)
        dist.all_gather_into_tensor(big, x)
        ok = float(big[0]) == 1.0 and float(big[-1]) == 2.0
    elif op == "reduce_scatter_tensor":
        rs = torch.empty(x.numel() // world, device=dev)
        dist.reduce_scatter_tensor(rs, x)
        ok = float(rs[0]) == 3.0
    elif op == "barrier":
        dist.barrier()
        ok = True
    else:
        if rank == 0:
            dist.send(x, 1)
        else:
            dist.recv(x, 0)
        ok = float(x[0]) == 1.0
    torch.cuda.synchronize()
    dist.destroy_process_group()
    with open(os.path.join(out, f"{op}.{rank}"), "w") as fh:
        fh.write("ok" if ok else "wrong value")


def timing(rank: int, world: int, store: str, out: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world,
                            rank=rank)
    dev = torch.device("cuda", 0)
    res = {}
    for n in SIZES:
        t = torch.ones(n, device=dev)
        for mode in ("cuda", "staged"):
            def run():
                if mode == "cuda":
                    dist.all_reduce(t)
                else:
                    h = t.cpu()
                    dist.all_reduce(h)
                    t.copy_(h)
            run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(REPS):
                run()
            torch.cuda.synchronize()
            res[f"all_reduce_{mode}_{4 * n}B_ms"] = (time.perf_counter() - t0) * 1e3 / REPS
        h = torch.ones(n)
        t0 = time.perf_counter()
        for _ in range(REPS):
            dist.all_gather([torch.empty_like(h) for _ in range(world)], h)
        res[f"all_gather_cpu_{4 * n}B_ms"] = (time.perf_counter() - t0) * 1e3 / REPS
    dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(out, "timing.json"), "w") as fh:
            json.dump(res, fh)


def nccl_world1(store: str) -> bool:
    dist.init_process_group("nccl", init_method=f"file://{store}", world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    x = torch.ones(8, device="cuda")
    dist.all_reduce(x)
    ys = [torch.empty_like(x)]
    dist.all_gather(ys, x)
    dist.barrier()
    dist.destroy_process_group()
    return bool((ys[0] == 1).all())


def main() -> int:
    if not torch.cuda.is_available():
        print("prof_collectives_torch: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}) on {smi}")
    work = tempfile.mkdtemp()
    takes = {}
    for i, op in enumerate(OPS):
        try:
            mp.start_processes(one_op, args=(2, os.path.join(work, f"s{i}"), op, work),
                               nprocs=2, start_method="spawn")
            got = [open(os.path.join(work, f"{op}.{r}")).read() for r in range(2)]
            takes[op] = "takes CUDA tensors" if got == ["ok", "ok"] else f"wrong: {got}"
        except (mp.ProcessExitedException, mp.ProcessRaisedException) as exc:
            takes[op] = f"fails: {str(exc).strip().splitlines()[-1][:160]}"
        print(f"  gloo {op}: {takes[op]}", flush=True)
    mp.start_processes(timing, args=(2, os.path.join(work, "t"), work), nprocs=2,
                       start_method="spawn")
    with open(os.path.join(work, "timing.json")) as fh:
        times = json.load(fh)
    for k, v in times.items():
        print(f"  {k}: {v:.3f}")
    nccl = nccl_world1(os.path.join(work, "n"))
    print(f"  nccl at world 1: {'ok' if nccl else 'wrong value'}")
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "prof_collectives.json"), "w") as fh:
        json.dump({"card": smi, "torch": torch.__version__, "gloo": takes,
                   "host_ms": times, "nccl_world1": nccl}, fh, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
