"""One rank of ``tests/test_torch_distributed.py``'s process-group case.

Kept apart from the test module so that a spawned rank imports torch and the
port only, not JAX.  Rank ``r`` joins a gloo group over ``tcp://127.0.0.1``,
loads the sharded index, holds shard ``r`` and runs its block of the batch
through the collective calls, then writes what it got to
``<out_dir>/rank<r>.pkl``.
"""
import datetime
import os
import pickle

import torch
import torch.distributed as dist

from repro_torch.core.tensor_index import pad_queries
from repro_torch.distributed import DistributedStringIndex, RoutingOverflowError
from repro_torch.index import IndexConfig


def rank_main(rank, world, port, sidx_path, blocks_path, out_dir, capacity, small):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=120))
    try:
        sidx = torch.load(sidx_path, weights_only=False)
        with open(blocks_path, "rb") as f:
            blocks = pickle.load(f)
        keys, starts, batch = (blocks[name][rank] for name in ("keys", "starts", "batch"))
        cpu = IndexConfig(device="cpu")
        dsi = DistributedStringIndex(sidx, group=dist.group.WORLD,
                                     per_dest_capacity=capacity, config=cpu)
        held = sorted(dsi._fn.shards)
        found, vals = dsi.get_batch(keys)
        windows = dsi.scan_entries(starts, 5)
        res = dsi.execute(batch)
        tight = DistributedStringIndex(sidx, group=dist.group.WORLD, per_dest_capacity=small,
                                       config=cpu)
        qb, ql = (torch.from_numpy(a) for a in pad_queries(keys, sidx.width))
        route = [t.numpy() for t in tight._fn(qb, ql)]
        try:
            tight.get_batch(keys)
            raised = None
        except RoutingOverflowError as e:
            raised = str(e)
        tight_res = tight.execute(batch)
        empty = dsi.get_batch([])
        out = {"held": held, "found": found, "vals": vals, "windows": windows,
               "results": res.results, "route": route, "raised": raised,
               "tight_results": tight_res.results, "empty": empty}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()
