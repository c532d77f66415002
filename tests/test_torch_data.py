"""The port's data loader (``lambdipy_tpu_torch/data/loader.py``) and the
process slice (``parallel/distributed.py``) against the JAX package's, on
the CPU. Exact: the windows, the batches over two epochs (shuffled and
not) and the slices are integers, and the port's must be bitwise JAX's;
a resumed loader replays the sequence bitwise; ``place`` gives an int64
tensor on the device asked for and refuses a mesh of more devices than
the job has processes."""

import numpy as np
import pytest
import torch

from lambdipy_tpu.data import ShardedLoader as JaxLoader
from lambdipy_tpu.data import TokenSource as JaxSource
from lambdipy_tpu.parallel.distributed import \
    process_batch_slice as jax_slice
from lambdipy_tpu_torch.data import ShardedLoader, TokenSource
from lambdipy_tpu_torch.parallel.distributed import (process_batch_slice,
                                                     process_count,
                                                     process_index)


def _tokens(n=1000):
    return np.random.default_rng(3).integers(0, 500, n).astype(np.int32)


@pytest.mark.parametrize("stride", [None, 5])
def test_windows_and_stride_are_jaxs(stride):
    """Every window, the count and the last partial window dropped."""
    toks = _tokens(203)
    got = TokenSource(toks, 9, stride=stride)
    want = JaxSource(toks, 9, stride=stride)
    assert len(got) == len(want)
    for i in range(len(want)):
        np.testing.assert_array_equal(got[i], want[i])
        assert got[i].dtype == np.int32


def test_npy_and_raw_files_are_jaxs(tmp_path):
    """A ``.npy`` file (memory-mapped) and a raw int32 file read the same
    windows in both packages."""
    toks = _tokens(64)
    np.save(tmp_path / "toks.npy", toks)
    toks.tofile(tmp_path / "toks.bin")
    for name in ("toks.npy", "toks.bin"):
        got, want = (cls(tmp_path / name, 7)
                     for cls in (TokenSource, JaxSource))
        assert len(got) == len(want)
        for i in range(len(want)):
            np.testing.assert_array_equal(got[i], want[i])


@pytest.mark.parametrize("tokens,seq_len", [
    (np.zeros((2, 2), np.int32), 4), (np.arange(4, dtype=np.int32), 8)],
    ids=["two_dims", "shorter_than_a_window"])
def test_source_validation_is_jaxs(tokens, seq_len):
    for cls in (TokenSource, JaxSource):
        with pytest.raises(ValueError):
            cls(tokens, seq_len)


def test_loader_refuses_a_batch_larger_than_the_source():
    src = _tokens(40)
    for cls, source in ((ShardedLoader, TokenSource),
                        (JaxLoader, JaxSource)):
        with pytest.raises(ValueError, match="one global batch"):
            cls(source(src, 15), 4, process_index=0, process_count=1)


@pytest.mark.parametrize("shuffle", [True, False],
                         ids=["shuffled", "in_order"])
@pytest.mark.parametrize("seed", [0, 7])
def test_batches_are_jaxs_over_two_epochs(shuffle, seed):
    """Batch t is bitwise JAX's over two epochs and a step into the
    third, and so is the loader's state after each batch."""
    toks = _tokens()
    got = ShardedLoader(TokenSource(toks, 15), 4, seed=seed,
                        shuffle=shuffle)
    want = JaxLoader(JaxSource(toks, 15), 4, seed=seed, shuffle=shuffle,
                     process_index=0, process_count=1)
    assert got.steps_per_epoch == want.steps_per_epoch == 16
    for _ in range(2 * want.steps_per_epoch + 1):
        b = got.next_batch()
        np.testing.assert_array_equal(b, want.next_batch())
        assert b.dtype == np.int32 and b.shape == (4, 16)
        assert got.state_dict() == want.state_dict()
    assert got.state.epoch == 2


def test_resume_replays_the_sequence():
    """A loader restored from another's state at step 5 gives the
    uninterrupted loader's batches from there on, as JAX's does."""
    toks = _tokens()
    solo = ShardedLoader(TokenSource(toks, 15), 4, seed=3)
    seq = [solo.next_batch() for _ in range(20)]
    first = ShardedLoader(TokenSource(toks, 15), 4, seed=3)
    for _ in range(5):
        first.next_batch()
    resumed = ShardedLoader(TokenSource(toks, 15), 4, seed=999)
    resumed.restore(first.state_dict())
    jax_resumed = JaxLoader(JaxSource(toks, 15), 4, seed=999,
                            process_index=0, process_count=1)
    jax_resumed.restore(first.state_dict())
    for want in seq[5:]:
        np.testing.assert_array_equal(resumed.next_batch(), want)
        np.testing.assert_array_equal(jax_resumed.next_batch(), want)


@pytest.mark.parametrize("count", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("batch", [8, 12, 16, 24])
def test_process_batch_slice_is_jaxs(batch, count):
    """(local batch, offset) for every process of every count, and the
    refusal of an uneven split, as JAX's."""
    for index in range(count):
        if batch % count:
            for fn in (process_batch_slice, jax_slice):
                with pytest.raises(ValueError, match="not divisible"):
                    fn(batch, process_index=index, process_count=count)
        else:
            assert process_batch_slice(batch, process_index=index,
                                       process_count=count) \
                == jax_slice(batch, process_index=index,
                             process_count=count)


def test_process_shards_are_jaxs_and_partition_the_batch():
    """Two processes' shards are JAX's and stack to the one-process
    batch; without a process group the port is one process of one."""
    toks = _tokens()
    assert (process_count(), process_index()) == (1, 0)
    whole = ShardedLoader(TokenSource(toks, 15), 4, seed=1).next_batch()
    shards = []
    for i in range(2):
        got = ShardedLoader(TokenSource(toks, 15), 4, seed=1,
                            process_index=i, process_count=2).next_batch()
        want = JaxLoader(JaxSource(toks, 15), 4, seed=1, process_index=i,
                         process_count=2).next_batch()
        np.testing.assert_array_equal(got, want)
        shards.append(got)
    np.testing.assert_array_equal(np.concatenate(shards), whole)


def test_place_gives_int64_on_the_device_and_refuses_a_mesh():
    """``place`` puts the batch on the asked device as int64 (one device
    named by a mesh or a sharding is taken); a mesh of more devices than
    the job has processes, or a loader sharded over more processes than
    the job has, raises, and so does an axis not ported yet, naming its
    item (two ranks: ``tests/test_torch_distributed.py``)."""
    loader = ShardedLoader(TokenSource(_tokens(), 15), 4)
    batch = loader.next_batch()
    for kw in ({"device": "cpu"}, {"mesh": {"dp": 1}, "device": "cpu"},
               {"batch_sharding": "cpu"}):
        t = loader.place(batch, **kw)
        assert t.dtype == torch.int64 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), batch)
    with pytest.raises(ValueError, match="needs 2 processes"):
        loader.place(batch, {"dp": 2, "tp": 1}, device="cpu")
    with pytest.raises(NotImplementedError, match=r"item 3 \(c\)"):
        loader.place(batch, {"tp": 2}, device="cpu")
    sharded = ShardedLoader(TokenSource(_tokens(), 15), 4, process_index=0,
                            process_count=2)
    with pytest.raises(ValueError, match="shards over 2 processes"):
        sharded.place(sharded.next_batch(), device="cpu")
