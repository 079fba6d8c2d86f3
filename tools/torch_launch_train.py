#!/usr/bin/env python3
"""One rank of an elastic training job under the port's launcher.

    python -m paddle_tpu_torch.distributed.launch --nnodes 1:2 \\
        --nproc_per_node 1 --master 127.0.0.1:PORT --elastic_ttl 2 \\
        tools/torch_launch_train.py --out DIR --ckpt DIR [--ref PATH]

Every incarnation of the job runs this script on each rank (the launcher
sets ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, ``PADDLE_MASTER``,
``PADDLE_LOCAL_RANK`` and, in elastic mode, ``PADDLE_ELASTIC``). It joins
the world over gloo (CUDA tensors on the card: two ranks on one device,
where NCCL refuses a second rank), builds its mesh through
``elastic_mesh.reshaped_mesh`` from the newest checkpoint's topology
(``{"sdp": -1}`` on a fresh start), restores that checkpoint resharded
onto the new mesh (``load_state(shardings=)``) and checks the restored
state against the shard files' crc32, keeps the global batch
(``rescale_batch``), and trains bench_gpt_primary's GPT-350M (or
``--tiny``: ``gpt_tiny``) under bf16 O2 with AdamW through
``group_sharded_parallel(model, opt, "os_g")`` (ZeRO-2 over "sdp") to
``--steps``, each rank saving its slices into one checkpoint every
``--save-every`` steps (``AutoCheckpoint`` with the multi-process
writer; the files are written on the save's own thread).

On a fresh start at world 2 it first runs the collective checks (new_group,
send/recv with and without a buffer, isend/irecv, batch_isend_irecv,
reduce, scatter, alltoall_single, all_gather_object on the rank's device,
every value checked exactly) and ``--localsgd-steps`` steps of
``fleet.distributed_model`` under ``strategy.localsgd`` (k_steps 2): the
ranks' parameter checksums, exchanged by ``all_gather_object``, must
differ before the first sync and be bit-equal right after each, and rank
0 replays the segment in one process (two replicas, their masters
averaged every second step) and holds the segment's losses and masters
to the replay.

Each rank appends JSON lines to ``--out/r<rank>_w<world>_p<pid>.jsonl``:
``boot``, ``collectives``, ``localsgd``, ``localsgd_reference``,
``restore``, one ``step`` a step
(loss, flash launches by kernel and route, wall time), ``save``, and
``done`` (the float32 masters' update error against ``--ref``, the
single-process yardstick ``chip_smoke._dist_reference`` writes, when
given). A failed check raises: the rank exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zlib

_T0 = time.time()
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

def _checksums(tensors) -> list:
    """Two integer sums of each tensor's bits (plain, and weighted by
    position): equal lists mean equal bits, up to a collision."""
    import torch

    out = []
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    for t in tensors:
        v = t.detach().contiguous().reshape(-1)
        v = v.view(ints[v.element_size()]).long()
        w = torch.arange(v.numel(), device=v.device) % 65521 + 1
        out.append((int(v.sum()), int((v * w).sum())))
    return out


class Report:
    def __init__(self, out_dir: str, rank: int, world: int):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir,
                                 f"r{rank}_w{world}_p{os.getpid()}.jsonl")
        self.rank, self.world = rank, world

    def __call__(self, event: str, **fields) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"event": event, "rank": self.rank,
                                "world": self.world, "time": time.time(),
                                **fields}) + "\n")


def collective_checks(dev) -> list:
    """The API's long tail between the two ranks on ``dev``, each value
    checked exactly. Returns the names of the checks that ran."""
    import torch

    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed import env

    r = env.get_rank()
    done = []

    def check(name, got, want):
        want = torch.as_tensor(want, dtype=got.dtype)
        if got.device != dev or not torch.equal(got.cpu(), want):
            raise AssertionError(f"{name} on rank {r}: {got} on {got.device}"
                                 f", expected {want} on {dev}")
        done.append(name)

    pair = D.new_group([0, 1])
    check("new_group_reduce", D.reduce(torch.full((3,), r + 1.0, device=dev),
                                       dst=1, group=pair),
          [0.0] * 3 if r == 0 else [3.0] * 3)
    x = torch.arange(6, dtype=torch.bfloat16, device=dev).reshape(2, 3)
    if r == 0:
        D.send(x, dst=1, tag=1)
        buf = torch.zeros(4, device=dev)
        D.recv(buf, src=1, tag=2)
        check("recv_into_buffer", buf, [7.0, 8.0, 9.0, 10.0])
        D.isend(torch.tensor([11, 12], device=dev), dst=1, tag=3).wait()
        reqs = D.batch_isend_irecv([
            D.P2POp(D.isend, torch.tensor([1.5], device=dev), 1, tag=4),
            D.P2POp(D.irecv, None, 1, tag=5)])
        check("batch_isend_irecv", reqs[1].wait(), [2.5])
        reqs[0].wait()
    else:
        check("recv_without_buffer", D.recv(src=0, tag=1),
              torch.arange(6, dtype=torch.bfloat16).reshape(2, 3))
        D.send(torch.tensor([7.0, 8.0, 9.0, 10.0], device=dev), dst=0, tag=2)
        check("isend_irecv", D.irecv(src=0, tag=3).wait(), [11, 12])
        reqs = D.batch_isend_irecv([
            D.P2POp(D.irecv, None, 0, tag=4),
            D.P2POp(D.isend, torch.tensor([2.5], device=dev), 0, tag=5)])
        check("batch_isend_irecv", reqs[0].wait(), [1.5])
        reqs[1].wait()
    check("reduce", D.reduce(torch.tensor([r + 1.0, 2.0], device=dev),
                             dst=0),
          [3.0, 4.0] if r == 0 else [0.0, 0.0])
    check("scatter", D.scatter(torch.arange(8.0, device=dev) * (r + 1),
                               src=1), [2.0 * i for i in range(4 * r,
                                                               4 * r + 4)])
    check("alltoall_single",
          D.alltoall_single(torch.arange(4.0, device=dev) + 10 * r),
          [2.0 * r, 2.0 * r + 1, 10 + 2.0 * r, 11 + 2.0 * r])
    objs = D.all_gather_object([], {"rank": r})
    if objs != [{"rank": 0}, {"rank": 1}]:
        raise AssertionError(f"all_gather_object on rank {r}: {objs}")
    done.append("all_gather_object")
    return done


def localsgd_segment(cfg, seed, batches, steps, dev_type, report):
    """``steps`` LocalSGD steps (k_steps 2) through fleet: the ranks'
    checksums after each step, and the gates. Returns the rows and this
    rank's float32 masters after the last step."""
    import torch

    import chip_smoke as cs
    import paddle_tpu_torch.distributed as D
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.mesh import set_mesh

    s = fleet.DistributedStrategy()
    s.localsgd = True
    s.localsgd_configs = {"k_steps": 2}
    fleet.init(strategy=s, backend="gloo", device=dev_type)
    model, opt = cs._primary_net(cfg, seed, device=dev_type)
    step = fleet.distributed_model(model, opt)
    rows = []
    for i in range(steps):
        loss = float(step((batches[i], batches[i])))
        sums = _checksums(step.replica_params().values())
        sums += _checksums(step.opt_state["master_weights"].values())
        both = D.all_gather_object([], sums)
        rows.append(dict(step=i, loss=loss, synced=(i + 1) % 2 == 0,
                         equal=both[0] == both[1]))
    masters = {k: v.detach().clone()
               for k, v in step.opt_state["master_weights"].items()}
    del step, model, opt
    set_mesh(None)
    if dev_type == "cuda":
        torch.cuda.empty_cache()
    if rows[0]["equal"]:
        raise AssertionError("localsgd: the replicas agree before the first "
                             "sync")
    bad = [r for r in rows if r["synced"] and not r["equal"]]
    if bad:
        raise AssertionError(f"localsgd: replicas differ after a sync: {bad}")
    report("localsgd", rows=rows, k_steps=2)
    return rows, masters


def localsgd_reference(cfg, seed, batches, rows, masters, dev_type,
                       report) -> dict:
    """The LocalSGD segment replayed in this one process: two bf16 O2
    replicas, each a single-process ``TrainStep`` on its half of every
    global batch, their float32 masters averaged (and the parameters cast
    from the average) every second step. The segment's averaged losses
    ``rows`` and its masters after the last step (a sync) are held to it:
    losses within ``DIST_LOSS_RTOL``, masters within the update error
    limits (see ``chip_smoke.DIST_UPDATE_RTOL``) of the replay's move."""
    import math

    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.framework.jit import TrainStep

    t0 = time.perf_counter()
    steps = []
    for _ in range(2):
        model, opt = cs._primary_net(cfg, seed, device=dev_type)
        steps.append(TrainStep(model, opt, loss_fn=None))
    live = [s.opt_state["master_weights"] for s in steps]
    init = {k: v.detach().clone() for k, v in live[0].items()}
    half = batches[0].shape[0] // 2
    losses = []
    for i in range(len(rows)):
        ids = [batches[i][r * half:(r + 1) * half] for r in range(2)]
        got = [float(s((x, x))) for s, x in zip(steps, ids)]
        losses.append((got[0] + got[1]) / 2)
        if (i + 1) % 2 == 0:
            with torch.no_grad():
                for k in init:
                    avg = (live[0][k] + live[1][k]) / 2
                    for s, m in zip(steps, live):
                        m[k].copy_(avg)
                        s.params[k].copy_(avg.to(s.params[k].dtype))
    loss_err = max(abs(r["loss"] - want) / abs(want)
                   for r, want in zip(rows, losses))
    worst, worst_name, num, den, biggest = -1.0, None, 0.0, 0.0, 0.0
    for k, want in live[0].items():
        d = (masters[k].float() - want).double()
        err = float(d.norm())
        moved = float((want - init[k]).double().norm())
        rel = err / moved if moved else (0.0 if err == 0 else math.inf)
        if rel > worst:
            worst, worst_name = rel, k
        num, den = num + err * err, den + moved * moved
        biggest = max(biggest, float(d.abs().max()))
    out = dict(losses=losses, loss_max_rel_err=loss_err,
               update_err_worst_leaf=worst, worst_leaf=worst_name,
               update_err_model=math.sqrt(num / den),
               master_max_abs_err=biggest,
               seconds=time.perf_counter() - t0)
    del steps, live, init, model, opt
    if dev_type == "cuda":
        torch.cuda.empty_cache()
    report("localsgd_reference", **out)
    if loss_err > cs.DIST_LOSS_RTOL \
            or worst > cs.DIST_UPDATE_RTOL \
            or out["update_err_model"] > cs.DIST_UPDATE_MODEL_RTOL:
        raise AssertionError(f"localsgd against its single-process replay: "
                             f"{out}")
    return out


def config(tiny: bool, layers: int, seq: int):
    """The job's GPT: bench_gpt_primary's GPT-350M at ``layers`` layers,
    or with ``tiny`` ``gpt_tiny`` (dropout off, no flash kernels, the
    chunked float32 loss as the full model's)."""
    import chip_smoke as cs

    if tiny:
        from paddle_tpu_torch.models.gpt import gpt_tiny

        return gpt_tiny(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
                        use_flash_attention=False, loss_chunk=16,
                        max_position_embeddings=max(seq, 64))
    return cs._primary_config(num_layers=layers)


def global_batches(cfg, seed: int, batch: int, seq: int, steps: int) -> list:
    """The global batch of every step (``chip_smoke._dist_batches``'s)."""
    import numpy as np

    rng = np.random.default_rng(seed + 20)
    return [rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int64)
            for _ in range(steps)]


def _leaves(tree, prefix=""):
    """``(flat key, tensor)`` of every tensor of a state tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        elif hasattr(v, "element_size"):
            yield f"{prefix}{k}", v


def _merged_shards(path: str) -> dict:
    """``{key: [shard records]}`` of a checkpoint, every process's
    metadata merged."""
    shards = {}
    for name in sorted(os.listdir(path)):
        if name == "metadata.json" or (name.startswith("metadata.")
                                       and name.endswith(".json")):
            with open(os.path.join(path, name)) as f:
                for key, rec in json.load(f)["leaves"].items():
                    shards.setdefault(key, []).extend(rec.get("shards", []))
    return shards


def _npy_crc32(data, bf16: bool) -> int:
    """crc32 of the bytes ``checkpoint._npy_bytes(data, bf16)`` would
    give, without building them: the header, then the array's buffer."""
    import io

    import numpy as np

    data = np.require(data, requirements="C")
    buf = io.BytesIO()
    header = ({"descr": "<V2", "fortran_order": False,
               "shape": tuple(data.shape)} if bf16
              else np.lib.format.header_data_from_array_1_0(data))
    np.lib.format.write_array_header_1_0(buf, header)
    crc = zlib.crc32(buf.getvalue())
    return zlib.crc32(memoryview(data.reshape(-1)).cast("B"), crc) \
        & 0xFFFFFFFF


def verify_restored(step, path: str) -> dict:
    """This rank's live state after a restore, cut as the shard files
    that wrote it were cut, against each file's recorded crc32: the
    restored state is bit-equal to what the ranks saved (every file that
    lies inside this rank's slice; at world 1, every file)."""
    from paddle_tpu_torch.distributed.checkpoint import _host_copy

    tree, shardings = step.sharded_state_dict()
    shards = _merged_shards(path)
    checked = mismatched = 0
    for key, sh in shardings.items():
        node = tree
        for part in key.split("/"):
            node = node[part]
        data, bf16 = _host_copy(node)
        blocked, boxes = sh.boxes(sh.global_shape(tuple(data.shape)))
        if blocked is not None or len(boxes) != 1:
            continue   # a fused split: its files are checked by load_state
        (lo, size), = [(b[0], b[1]) for b in boxes]
        for rec in shards[key]:
            # a file inside this rank's slice (another rank checks the rest)
            if any(a < l or a + n > l + s for a, n, l, s in
                   zip(rec["start"], rec["shape"], lo, size)):
                continue
            box = tuple(slice(a - l, a - l + n) for a, n, l in
                        zip(rec["start"], rec["shape"], lo))
            checked += 1
            if _npy_crc32(data[box], bf16) != rec["crc32"]:
                mismatched += 1
    if mismatched or not checked:
        raise AssertionError(f"restore: {mismatched} of {checked} shard "
                             f"files differ from the restored state")
    return dict(shard_files_checked=checked, bit_equal=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--ref", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=13)
    ap.add_argument("--save-every", type=int, default=4)
    ap.add_argument("--localsgd-steps", type=int, default=4)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--tiny", action="store_true",
                    help="gpt_tiny instead of GPT-350M")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--pace", type=float, default=0.0,
                    help="seconds to sleep after each world-2 step (lets a "
                         "drill kill a node mid-run)")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from paddle_tpu_torch import default_device
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.distributed.checkpoint import (AutoCheckpoint,
                                                         last_load_stats,
                                                         latest_checkpoint,
                                                         load_state,
                                                         mesh_info,
                                                         validate_checkpoint)
    from paddle_tpu_torch.distributed import (elastic_mesh,
                                              group_sharded_parallel)
    from paddle_tpu_torch.distributed.shard import DistributedTrainStep
    from paddle_tpu_torch.kernels import flash_attention as fa

    cuda = args.device == "cuda"
    if cuda:
        default_device("cuda")
    env.init_parallel_env(backend="gloo", device=args.device)
    rank, world = env.get_rank(), env.get_world_size()
    dev = env.device() if cuda else torch.device("cpu")
    report = Report(args.out, rank, world)
    report("boot", seconds=time.time() - _T0, started=_T0,
           elastic=elastic_mesh.is_elastic(), device=str(dev))
    cfg = config(args.tiny, args.layers, args.seq)
    batches = global_batches(cfg, args.seed, args.batch, args.seq,
                             args.steps)
    need = cs._need(**{k: cfg.num_layers for k in cs.HF_NEED}) \
        if cfg.use_flash_attention else cs._need()
    fresh = latest_checkpoint(args.ckpt, verify=False) is None
    if fresh and world == 2:
        t0 = time.perf_counter()
        checks = collective_checks(dev)
        report("collectives", checks=checks,
               seconds=time.perf_counter() - t0)
        if args.localsgd_steps:
            t0 = time.perf_counter()
            fa.reset_launch_counts()
            rows, masters = localsgd_segment(cfg, args.seed, batches,
                                             args.localsgd_steps,
                                             args.device, report)
            report("localsgd_done", seconds=time.perf_counter() - t0,
                   launches=list(cs._counts(fa)) if cuda else None)
            if rank == 0:   # rank 1 waits for it in the next collective
                localsgd_reference(cfg, args.seed, batches, rows, masters,
                                   args.device, report)
            del masters

    t0 = time.perf_counter()
    mesh = elastic_mesh.reshaped_mesh(args.ckpt, default_axes={"sdp": -1})
    per_replica = elastic_mesh.rescale_batch(args.batch, dict(mesh.shape))
    model, opt = cs._primary_net(cfg, args.seed, device=args.device)
    model, opt, _ = group_sharded_parallel(model, opt, "os_g")
    step = DistributedTrainStep(model, opt, loss_fn=None, mesh=mesh,
                                overlap_grad_reduce=True)
    if per_replica * step._n_batch != args.batch:
        raise AssertionError(f"per-replica batch {per_replica} x "
                             f"{step._n_batch} != {args.batch}")
    ckpt = AutoCheckpoint(args.ckpt, save_interval_steps=args.save_every,
                          keep_max=2, async_save=True)
    report("built", seconds=time.perf_counter() - t0, mesh=dict(mesh.shape),
           per_replica_batch=per_replica, sharding_stage=step.sharding_stage)
    start = 0
    # the newest checkpoint every rank committed (a stat-only check: the
    # restore below verifies each shard's crc32 as it reads it)
    path = latest_checkpoint(args.ckpt, verify=False)
    if path is not None:
        problem = validate_checkpoint(path, checksums=False)
        if problem is not None:
            raise AssertionError(f"restore: {problem}")
        t0 = time.perf_counter()
        _, shardings = step.sharded_state_dict()
        flat = load_state(path, shardings=shardings)
        step.set_sharded_state_dict(flat)
        if cuda:
            torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        stats = last_load_stats()
        start = step._count
        t0 = time.perf_counter()
        checked = verify_restored(step, path)
        report("restore", path=os.path.basename(path), step=start,
               seconds=restore_s, verify_seconds=time.perf_counter() - t0,
               bytes_read=stats["bytes_read"],
               peak_resident_bytes=stats["peak_resident_bytes"],
               written_on=mesh_info(path), mesh=dict(mesh.shape),
               **checked)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for i in range(start, args.steps):
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        loss = float(step((batches[i], batches[i])))
        launches = list(cs._counts(fa)) if cuda else None
        if cuda and cfg.use_flash_attention and tuple(launches) != need:
            raise AssertionError(f"step {i}: launches {launches}, "
                                 f"expected {list(need)}")
        report("step", step=i, loss=loss, launches=launches,
               seconds=time.perf_counter() - t0, wall=time.time(),
               peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                         if cuda else None))
        if (i + 1) % args.save_every == 0 and i + 1 < args.steps:
            t0 = time.perf_counter()
            state, shardings = step.sharded_state_dict()
            # the host copies here, the files on the save's own thread
            ckpt.save(i + 1, state, shardings=shardings, mesh=mesh)
            report("save", step=i + 1, seconds=time.perf_counter() - t0,
                   bytes=sum(t.numel() * t.element_size()
                             for key, t in _leaves(state)
                             if shardings[key].writer))
        if world > 1 and args.pace:
            time.sleep(args.pace)
    done = dict(steps=args.steps, peak_gib=(
        torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None))
    if args.ref:
        ref = torch.load(args.ref, weights_only=False, mmap=True)
        done.update(cs._update_error(step, mesh, ref))
    t0 = time.perf_counter()
    ckpt.wait()
    report("done", wait_seconds=time.perf_counter() - t0, **done)
    import torch.distributed as tdist

    tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
