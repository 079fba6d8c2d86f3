"""The port's input pipeline (``paddle_tpu_torch.io``: datasets, samplers,
the DataLoader with its worker processes, tail padding and length buckets,
the cursor and the device prefetch) against the JAX package's, on the CPU.

Parity: the same datasets through both loaders give equal batches, masks
and worker seeds (exactly: both stop at numpy), with ``num_workers`` 0 and
2, ``drop_last``, ``pad_batches`` and ``length_buckets``. The rest are
twins of ``tests/test_input_pipeline.py`` and
``tests/test_dataloader_mp.py`` on the port alone.
"""
import gc
import itertools
import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.io as jio
import paddle_tpu_torch.io as tio
from paddle_tpu_torch.framework import random as trandom
from paddle_tpu_torch.io import (DataLoader, Dataset, IterableDataset,
                                 PaddedBatcher, bucket_for,
                                 default_collate_fn, get_worker_info,
                                 prefetch_to_device, resume_batches)
from paddle_tpu_torch.io.cursor import DataCursor
from paddle_tpu_torch.io.dataloader import _PrefetchIterator

LENGTHS = (12, 20, 28)
BUCKETS = (16, 32)


class RaggedDataset:
    """(ids[L], label): lengths in blocks of 8 samples, 22 samples -> a
    ragged tail batch of 2 at batch size 4. Plain indexable, so both
    packages' loaders take it."""

    def __len__(self):
        return 22

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        L = LENGTHS[min(i // 8, len(LENGTHS) - 1)]
        return (np.asarray(rng.integers(1, 64, L), np.int64),
                np.int64(i % 4))


class SeedDataset:
    """Each sample carries its worker's id and seed and a draw from both
    of the worker's reseeded RNGs."""

    def __init__(self, info_fn):
        self.info_fn = info_fn

    def __len__(self):
        return 12

    def __getitem__(self, i):
        import random

        info = self.info_fn()
        wid, seed = (-1, -1) if info is None else (info.id, info.seed)
        return np.asarray([i, wid, seed, np.random.randint(0, 2 ** 31),
                           random.getrandbits(31)], np.int64)


def _flat(batch):
    return batch if isinstance(batch, (tuple, list)) else (batch,)


def _assert_batches_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = _flat(x), _flat(y)
        assert len(x) == len(y)
        for u, v in zip(x, y):
            u, v = np.asarray(u), np.asarray(v)
            assert u.dtype == v.dtype and u.shape == v.shape
            np.testing.assert_array_equal(u, v)


# ---------------------------------------------------------------- parity
@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("opts", [
    dict(),
    dict(drop_last=True),
    dict(pad_batches=True),
    dict(pad_batches=True, length_buckets=BUCKETS),
    dict(length_buckets=BUCKETS, drop_last=True),
], ids=["plain", "drop_last", "pad", "pad_buckets", "buckets_drop_last"])
def test_batches_and_masks_equal_the_reference(num_workers, opts):
    ds = RaggedDataset()
    if not opts.get("length_buckets") and not opts.get("pad_batches"):
        # unbucketed ragged samples cannot stack: a fixed-length view
        ds = jio.Subset(ds, range(8))
    got = list(DataLoader(ds, batch_size=4, shuffle=False,
                          num_workers=num_workers, **opts))
    want = list(jio.DataLoader(ds, batch_size=4, shuffle=False,
                               num_workers=num_workers, **opts))
    _assert_batches_equal(got, want)
    if opts.get("pad_batches"):
        assert all(b[-1].dtype == np.bool_ for b in got)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_worker_seeds_and_draws_equal_the_reference(num_workers):
    kw = dict(batch_size=3, num_workers=num_workers, seed=17)
    got = np.concatenate(list(DataLoader(SeedDataset(get_worker_info), **kw)))
    want = np.concatenate(list(jio.DataLoader(
        SeedDataset(jio.get_worker_info), **kw)))
    if num_workers == 0:
        assert (got[:, 1] == -1).all()
        np.testing.assert_array_equal(got[:, :3], want[:, :3])
    else:
        # workers seed seed + epoch_seed * 1000003 + worker id and reseed
        # numpy and stdlib random from it: every draw matches
        assert set(got[:, 1].tolist()) == {0, 1}
        assert set(got[:, 2].tolist()) == {17, 18}
        np.testing.assert_array_equal(got, want)


def test_samplers_and_splits_equal_the_reference():
    ds = RaggedDataset()
    for nr, rank in ((3, 0), (3, 2)):
        for shuffle, drop in ((False, False), (True, True)):
            a = tio.DistributedBatchSampler(ds, 4, num_replicas=nr,
                                            rank=rank, shuffle=shuffle,
                                            drop_last=drop)
            b = jio.DistributedBatchSampler(ds, 4, num_replicas=nr,
                                            rank=rank, shuffle=shuffle,
                                            drop_last=drop)
            a.set_epoch(3)
            b.set_epoch(3)
            assert list(a) == list(b) and len(a) == len(b)
    single = tio.DistributedBatchSampler(ds, 5)
    assert (single.nranks, single.local_rank) == (1, 0)
    trandom.seed(5)
    pt.seed(5)
    got = [s.indices for s in tio.random_split(ds, [10, 12])]
    want = [s.indices for s in jio.random_split(ds, [10, 12])]
    assert got == want
    bs = tio.BatchSampler(ds, batch_size=5, drop_last=True)
    assert list(bs) == list(jio.BatchSampler(ds, batch_size=5,
                                             drop_last=True))
    # RandomSampler is unseeded, as the reference's: a permutation
    perm = list(tio.RandomSampler(ds))
    assert sorted(perm) == list(range(22))


def test_dataset_combinators_equal_the_reference():
    a = np.arange(12).reshape(6, 2)
    b = np.arange(6) * 10
    for mod in (tio, jio):
        t = mod.TensorDataset([a, b])
        cat = mod.ConcatDataset([t, mod.Subset(t, [5, 0])])
        comp = mod.ComposeDataset([t, mod.TensorDataset([b])])
        got = ([cat[i] for i in range(len(cat))],
               [comp[i] for i in range(len(comp))],
               [x for x in iter(mod.ChainDataset([[1, 2], [3]]))])
        if mod is tio:
            port = got
    assert port[2] == got[2] == [1, 2, 3]
    _assert_batches_equal(port[0], got[0])
    _assert_batches_equal(port[1], got[1])


@pytest.mark.parametrize("num_workers", [0, 2])
def test_resume_batches_equal_the_reference(num_workers):
    ds = RaggedDataset()
    kw = dict(batch_size=3, num_workers=num_workers, pad_batches=True,
              length_buckets=BUCKETS)
    got = list(resume_batches(DataLoader(ds, **kw), 2))
    from paddle_tpu.io.cursor import resume_batches as jresume
    want = list(jresume(jio.DataLoader(ds, **kw), 2))
    _assert_batches_equal(got, want)
    assert list(resume_batches(DataLoader(ds, **kw), 99)) == []


# ---------------------------------------- twins of test_input_pipeline.py
class TestDefaultCollate:
    def test_dtypes(self):
        assert default_collate_fn([True, False]).dtype == np.bool_
        assert default_collate_fn([np.bool_(True)]).dtype == np.bool_
        assert default_collate_fn([np.int16(1), np.int16(2)]).dtype \
            == np.int16
        assert default_collate_fn([1, 2, 3]).dtype.kind == "i"
        assert default_collate_fn([1.0, 2.0]).dtype.kind == "f"
        out = default_collate_fn([{"a": np.ones(2), "b": (1, 2.0)}] * 3)
        assert out["a"].shape == (3, 2) and out["b"][0].shape == (3,)

    def test_empty_batch_raises_value_error(self):
        with pytest.raises(ValueError, match="empty batch"):
            default_collate_fn([])


class TestBucketing:
    def test_bucket_for(self):
        assert [bucket_for(n, (16, 32)) for n in (1, 16, 17, 32, 33, 65)] \
            == [16, 16, 32, 32, 64, 96]
        assert all(bucket_for(L, (32, 16)) == bucket_for(L, (16, 32))
                   for L in range(1, 70))
        with pytest.raises(ValueError):
            bucket_for(5, (0, 16))

    def test_batch_level_bucket_and_length_fields(self):
        b = PaddedBatcher(batch_size=2, pad_batches=False,
                          length_buckets=BUCKETS)
        out = b([(np.zeros(12, np.int64), np.int64(0)),
                 (np.zeros(20, np.int64), np.int64(1))])
        assert out[0].shape == (2, 32)
        b = PaddedBatcher(batch_size=2, pad_batches=False,
                          length_buckets=(16,), length_fields=(0,))
        out = b([(np.zeros(12, np.int64), np.ones(10, np.float32)),
                 (np.zeros(9, np.int64), np.ones(10, np.float32))])
        assert out[0].shape == (2, 16) and out[1].shape == (2, 10)


class TestTailPadding:
    def test_tail_padded_and_masked(self):
        batches = list(DataLoader(RaggedDataset(), batch_size=4,
                                  shuffle=False, pad_batches=True,
                                  length_buckets=BUCKETS))
        assert len(batches) == 6
        assert {b[0].shape for b in batches} == {(4, 16), (4, 32)}
        ids, label, mask = batches[-1]
        np.testing.assert_array_equal(mask, [True, True, False, False])
        np.testing.assert_array_equal(ids[3], ids[1])
        assert label[2] == label[1]

    def test_sequence_padding_zero_filled(self):
        ids, label, mask = PaddedBatcher(
            batch_size=4, length_buckets=(16,))([(np.ones(10, np.int64),
                                                  np.int64(1))])
        assert ids.shape == (4, 16)
        np.testing.assert_array_equal(ids[0, 10:], np.zeros(6, np.int64))
        np.testing.assert_array_equal(mask, [True, False, False, False])
        with pytest.raises(ValueError):
            PaddedBatcher(batch_size=4)([])


class TestPrefetchIterator:
    def test_values_order_and_stats(self):
        it = _PrefetchIterator(iter(range(10)), depth=3)
        assert list(it) == list(range(10))
        assert it.stats()["batches"] == 10
        assert it.stats()["consumer_stall_s"] >= 0.0

    def test_overlap_producer_runs_ahead(self):
        produced = {}

        def stamp(x):
            produced[x] = time.perf_counter()
            return x

        completed = {}
        for x in _PrefetchIterator(iter(range(5)), depth=2, transform=stamp):
            time.sleep(0.03)
            completed[x] = time.perf_counter()
        for n in range(1, 5):
            assert produced[n] < completed[n - 1]

    def test_error_delivered_promptly(self):
        def gen():
            yield 1
            yield 2
            raise RuntimeError("producer boom")

        it = _PrefetchIterator(gen(), depth=8)
        deadline = time.monotonic() + 5.0
        while it._state.err is None and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(RuntimeError, match="producer boom"):
            next(it)
        with pytest.raises(StopIteration):
            next(it)

    def test_close_unblocks_and_joins(self):
        it = _PrefetchIterator(itertools.count(), depth=2)
        assert next(it) == 0
        th = it._thread
        it.close()
        assert not th.is_alive()
        with pytest.raises(StopIteration):
            next(it)
        it.close()

    def test_abandoned_iterator_does_not_leak_thread(self):
        it = _PrefetchIterator(itertools.count(), depth=2)
        next(it)
        th = it._thread
        del it
        gc.collect()
        th.join(timeout=5.0)
        assert not th.is_alive()


class TestDevicePrefetch:
    def test_values_on_cpu_tensors(self):
        batches = [(np.full((2, 3), i, np.float32), np.int64(i), "tag")
                   for i in range(4)]
        it = prefetch_to_device(iter(batches), depth=2, device="cpu")
        out = list(it)
        assert len(out) == 4
        for i, (x, y, tag) in enumerate(out):
            assert isinstance(x, torch.Tensor) and x.dtype == torch.float32
            np.testing.assert_array_equal(x.numpy(), batches[i][0])
            assert int(y) == i and tag == "tag"
        assert it.stats()["batches"] == 4
        assert "consumer_stall_s" in it.stats()

    def test_close_and_gc_join_the_thread(self):
        it = prefetch_to_device(itertools.repeat((np.zeros(2),)), depth=2,
                                device="cpu")
        next(it)
        th = it._thread
        it.close()
        assert not th.is_alive()
        it = prefetch_to_device(itertools.repeat((np.zeros(2),)), depth=2,
                                device="cpu")
        next(it)
        th = it._thread
        del it
        gc.collect()
        th.join(timeout=5.0)
        assert not th.is_alive()

    def test_through_dataloader_with_workers(self):
        loader = DataLoader(RaggedDataset(), batch_size=4, shuffle=False,
                            num_workers=2, pad_batches=True,
                            length_buckets=BUCKETS)
        host = list(loader)
        got = list(prefetch_to_device(iter(loader), depth=2, device="cpu"))
        assert len(got) == len(host) == 6
        for a, b in zip(got, host):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u.numpy(), v)

    def test_default_device_is_the_card_and_sharding_waits(self):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                prefetch_to_device(iter([]))
        # the sharded landing has landed (its world of two is in
        # tests/test_torch_launch.py): a mesh needs the batch's spec
        from paddle_tpu_torch.distributed.mesh import P, init_mesh, set_mesh

        mesh = init_mesh(dp=1)
        try:
            with pytest.raises(ValueError, match="spec="):
                prefetch_to_device(iter([]), device="cpu", mesh=mesh)
            it = prefetch_to_device(iter([np.arange(4)]), device="cpu",
                                    mesh=mesh, spec=P("dp"))
            assert next(it).tolist() == [0, 1, 2, 3]
            it.close()
        finally:
            set_mesh(None)


# ------------------------------------------ twins of test_dataloader_mp.py
class RangeSquares(Dataset):
    def __init__(self, n=64):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.asarray([i, i * i], np.int64)


class PidDataset(Dataset):
    def __len__(self):
        return 16

    def __getitem__(self, i):
        return np.asarray([os.getpid()], np.int64)


class ShardedCounter(IterableDataset):
    def __init__(self, stop=40):
        self.stop = stop

    def __iter__(self):
        info = get_worker_info()
        lo, step = (0, 1) if info is None else (info.id, info.num_workers)
        for i in range(lo, self.stop, step):
            yield np.asarray([i], np.int64)


class BoomDataset(Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("boom at 5")
        return np.asarray([i], np.int64)


class CudaProbeDataset(Dataset):
    """Reports whether torch initialised CUDA in the worker."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        return np.asarray([int(torch.cuda.is_initialized())], np.int64)


def test_order_matches_single_process_and_workers_are_processes():
    ds = RangeSquares(64)
    single = list(DataLoader(ds, batch_size=8, num_workers=0))
    multi = list(DataLoader(ds, batch_size=8, num_workers=3))
    _assert_batches_equal(single, multi)
    pids = np.concatenate([b.ravel() for b in DataLoader(
        PidDataset(), batch_size=2, num_workers=2)])
    assert os.getpid() not in set(pids.tolist())
    assert len(set(pids.tolist())) == 2
    # workers collate numpy only: they never bring CUDA up
    probe = np.concatenate(list(DataLoader(CudaProbeDataset(), batch_size=2,
                                           num_workers=2)))
    assert (probe == 0).all()


def test_worker_init_fn_runs_in_workers_only():
    seen = []
    list(DataLoader(RangeSquares(8), batch_size=2, num_workers=2,
                    worker_init_fn=seen.append))
    assert seen == []


def test_rng_differs_across_epochs():
    dl = DataLoader(SeedDataset(get_worker_info), batch_size=6,
                    num_workers=2)
    e1 = np.concatenate(list(dl))
    e2 = np.concatenate(list(dl))
    assert not np.array_equal(e1[:, 3:], e2[:, 3:])
    assert dl._epoch_seed == 2


def test_concurrent_and_persistent_iterators():
    ds = RangeSquares(32)
    expected = list(DataLoader(ds, batch_size=4, num_workers=0))
    dl = DataLoader(ds, batch_size=4, num_workers=2)
    a, b = iter(dl), iter(dl)
    _assert_batches_equal(expected, [next(a) for _ in range(8)])
    _assert_batches_equal(expected, [next(b) for _ in range(8)])
    dl = DataLoader(ds, batch_size=4, num_workers=2, persistent_workers=True)
    it1 = iter(dl)
    next(it1)
    it2 = iter(dl)
    with pytest.raises(RuntimeError, match="invalidated"):
        next(it1)
    assert len(list(it2)) == 8
    dl._shutdown_workers()


def test_persistent_workers_reuse_processes_and_abandon_cleanly():
    dl = DataLoader(PidDataset(), batch_size=2, num_workers=2,
                    persistent_workers=True)
    pids1 = set(np.concatenate([b.ravel() for b in dl]).tolist())
    pids2 = set(np.concatenate([b.ravel() for b in dl]).tolist())
    assert pids1 == pids2
    dl._shutdown_workers()
    ds = RangeSquares(64)
    dl = DataLoader(ds, batch_size=8, num_workers=2, persistent_workers=True)
    it = iter(dl)
    next(it)
    next(it)  # abandon with outstanding credits
    _assert_batches_equal(list(DataLoader(ds, batch_size=8)), list(dl))
    dl._shutdown_workers()


def test_iterable_dataset_sharded():
    got = np.sort(np.concatenate([b.ravel() for b in DataLoader(
        ShardedCounter(40), batch_size=4, num_workers=3)]))
    np.testing.assert_array_equal(got, np.arange(40))
    vals = np.concatenate([b.ravel() for b in DataLoader(
        ShardedCounter(20), batch_size=3, num_workers=0)])
    np.testing.assert_array_equal(np.sort(vals), np.arange(20))


def test_worker_errors_propagate():
    with pytest.raises(RuntimeError, match="boom at 5"):
        list(DataLoader(BoomDataset(), batch_size=2, num_workers=2))
    dl = DataLoader(RangeSquares(4), batch_size=2, num_workers=1,
                    collate_fn=lambda batch: (np.stack(batch), lambda: 1))
    with pytest.raises(RuntimeError, match="pickle|Pickling"):
        list(dl)


def test_data_cursor_roundtrip_and_rescale():
    c = DataCursor(epoch=2, batch_index=5, epoch_seed=3, global_step=37)
    assert DataCursor.from_state(c.as_state()) == c
    assert DataCursor.from_state(None) is None
    r = c.rescale(8, 16)
    assert (r.batch_index, r.epoch, r.global_step) == (2, 2, 37)
    from paddle_tpu.io.cursor import DataCursor as JCursor
    assert JCursor(**c.as_state()).rescale(8, 16).as_state() == r.as_state()


def test_no_thread_leak_after_prefetched_epochs():
    before = threading.active_count()
    for _ in range(3):
        list(prefetch_to_device(iter(DataLoader(RangeSquares(16),
                                                batch_size=4)),
                                depth=2, device="cpu"))
    gc.collect()
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_closing_an_iterator_mid_epoch_ends_its_workers():
    it = iter(DataLoader(RangeSquares(64), batch_size=4, num_workers=2))
    next(it)
    workers = list(it._pool.workers)
    it.close()
    for w in workers:
        w.join(timeout=10.0)
        assert not w.is_alive()
    with pytest.raises(StopIteration):
        next(it)
