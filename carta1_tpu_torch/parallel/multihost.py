"""Multi-process launch of the corpus transcoder.

The port of `carta1_tpu/parallel/multihost.py`.  Every process runs the
same command; files stripe across processes by rank (stateless above the
file level, so a lost process's share is simply run again, see
`parallel/corpus.py`), and within a process a file's frames may shard
across its cards (`parallel/sharding.py`).  The process group is gloo:
it only stripes files, so it needs no collective on the card, and it
works on the CPU and among processes that share one card.

    # on every host, with its own --process-id:
    python -m carta1_tpu_torch.parallel.multihost --coordinator host0:8476 \\
        --num-processes 2 --process-id 0 --encode 'corpus/*.wav' --out-dir encoded/ --checkpoint ckpt.json

    # or under torchrun, which sets RANK, WORLD_SIZE, MASTER_ADDR and LOCAL_RANK:
    torchrun --nproc-per-node 4 -m carta1_tpu_torch.parallel.multihost --encode 'corpus/*.wav' --out-dir encoded/
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import torch

from carta1_tpu_torch.options import EncoderOptions
from carta1_tpu_torch.parallel.corpus import transcode_corpus


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> tuple[int, int]:
    """Join a gloo process group and return (rank, world size).

    With `coordinator` ("host:port" of process 0) the group is made from it,
    `num_processes` and `process_id`; without one, from torchrun's RANK,
    WORLD_SIZE and MASTER_ADDR/MASTER_PORT when they are set.  Alone it
    does nothing and returns (0, 1)."""
    dist = torch.distributed
    if not dist.is_initialized():
        if coordinator:
            dist.init_process_group("gloo", init_method=f"tcp://{coordinator}", world_size=num_processes,
                                    rank=process_id)
        elif all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
            dist.init_process_group("gloo", init_method="env://")
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="carta1-torch-multihost", description="Distributed corpus transcoder")
    p.add_argument("--coordinator", help="host:port of process 0 (omit for one process, or under torchrun)")
    p.add_argument("--num-processes", type=int, help="total process count (with --coordinator)")
    p.add_argument("--process-id", type=int, help="this process's id (with --coordinator)")
    p.add_argument("--encode", metavar="GLOB", help="encode WAV files matching GLOB")
    p.add_argument("--decode", metavar="GLOB", help="decode AEA files matching GLOB")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--checkpoint", help="JSON checkpoint path for resume (one file per process: PATH.p<rank>)")
    p.add_argument("--bias", type=float)
    p.add_argument("--engine", choices=("tpu", "exact"), default="tpu")
    p.add_argument("--device", help="device of this process (default: cuda:LOCAL_RANK under torchrun; else the "
                                    "card, or every visible card as a mesh when there are several); no fallback")
    args = p.parse_args(argv)

    if bool(args.encode) == bool(args.decode):
        print("Error: exactly one of --encode/--decode required", file=sys.stderr)
        return 1

    device = args.device
    if device is None and "LOCAL_RANK" in os.environ:
        device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
    pi, pc = initialize(args.coordinator, args.num_processes, args.process_id)
    try:
        options = EncoderOptions()
        if args.bias is not None:
            options = options.replace(allocation_bias=args.bias)

        mode = "encode" if args.encode else "decode"
        pattern = args.encode or args.decode
        ext = ".aea" if mode == "encode" else ".wav"
        inputs = sorted(glob.glob(pattern))
        os.makedirs(args.out_dir, exist_ok=True)
        jobs = [
            (path, os.path.join(args.out_dir, os.path.splitext(os.path.basename(path))[0] + ext))
            for path in inputs
        ]

        ckpt = args.checkpoint
        if ckpt and pc > 1:
            ckpt = f"{ckpt}.p{pi}"  # per-process checkpoint files
        result = transcode_corpus(
            jobs, mode=mode, options=options, checkpoint_path=ckpt,
            process_index=pi, process_count=pc, device=device, engine=args.engine,
        )
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    print(json.dumps({
        "process": pi,
        "processes": pc,
        "completed": len(result.completed),
        "skipped": len(result.skipped),
        "failed": len(result.failed),
        "frames": result.frames,
        "realtime_multiple": round(result.realtime_multiple, 1),
    }))
    for path, err in result.failed.items():
        print(f"FAILED {path}: {err.splitlines()[0]}", file=sys.stderr)
    return 0 if not result.failed else 2


if __name__ == "__main__":
    sys.exit(main())
