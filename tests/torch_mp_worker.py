"""One rank of a multi-process run of canu_tpu_torch's stages on the CPU
(tests/test_torch_multiprocess.py).

    python tests/torch_mp_worker.py stages <rank> <world> <init url> <work> <fasta>
    python tests/torch_mp_worker.py pipeline <work> <fasta>

``stages``: joins a gloo world and runs the cor gatekeeper, meryl and
overlap stages with shardedCompute=auto, once for each ovsShardExchange
(range, allgather), each in <work>/<exchange>; rank 0 writes what the
test compares to <work>/<exchange>/result.json.  ``pipeline``: the
command line (canu_tpu_torch.__main__.main) with useGrid=true on the
CPU from raw reads, the world taken from the launcher's environment
(torchrun's, set by the test).  Imports nothing of jax or canu_tpu.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

EXCHANGES = ("range", "allgather")
GENOME = 8_000
PIPELINE_GENOME = 30_000


def stage_config(exchange: str = "range"):
    from canu_tpu_torch.config import Config

    cfg = Config()
    cfg.set("genomeSize", GENOME)
    cfg.set("ovsShardExchange", exchange)
    return cfg


def frequent_digest(path: str) -> str:
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    with np.load(path) as z:
        for n in ("kmers", "fraction", "threshold", "total", "k"):
            h.update(np.ascontiguousarray(z[n]).tobytes())
    return h.hexdigest()


def stages_main(rank: int, world: int, url: str, work: str, fasta: str) -> None:
    from canu_tpu_torch.parallel import launch
    from canu_tpu_torch.pipeline import stages
    from canu_tpu_torch.pipeline.driver import make_ctx
    from canu_tpu_torch.stores.overlaps import store_digest

    torch.set_num_threads(1)
    launch.init_distributed(url, world, rank, device="cpu")
    for exchange in EXCHANGES:
        launch.STATS.clear()
        cfg = stage_config(exchange)
        assert stages.sharded_enabled(cfg)
        ctx = make_ctx(os.path.join(work, exchange), "t", cfg)
        rs = stages.gatekeeper(ctx, "cor", [fasta])
        fk = stages.meryl(ctx, "cor", rs, device="cpu")
        st = stages.overlap(ctx, "cor", rs, fk, device="cpu")
        shards = [f for f in os.listdir(ctx.phase_dir("correction")) if ".shard" in f]
        if rank == 0:
            with open(os.path.join(work, exchange, "result.json"), "w") as fh:
                json.dump({"store": store_digest(st), "rows": len(st), "shards_left": shards,
                           "frequent": frequent_digest(ctx.path("correction",
                                                                "t.ms16.frequent.npz")),
                           "stats": {k: v[0] for k, v in launch.STATS.items()}}, fh)
    launch.shutdown()
    print("RANK_OK", rank, flush=True)


def pipeline_main(work: str, fasta: str) -> None:
    from canu_tpu_torch.__main__ import main

    torch.set_num_threads(1)
    rc = main(["-p", "asm", "-d", work, f"genomeSize={PIPELINE_GENOME}", "useGrid=true",
               "-pacbio-raw", fasta], device="cpu")
    from canu_tpu_torch.parallel import launch

    print("RANK_OK", launch.rank_world(), rc, flush=True)
    launch.shutdown()
    sys.exit(rc)


if __name__ == "__main__":
    if sys.argv[1] == "stages":
        stages_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6])
    else:
        pipeline_main(sys.argv[2], sys.argv[3])
