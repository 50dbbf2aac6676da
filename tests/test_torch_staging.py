"""Device staging (``data/pipeline.py::device_prefetch``) on the CPU: the
same batches in the same order as ``to_device``, a producer's error raised
in the consumer, an early stop that leaves no producer thread behind, and
the ``--tiny`` Trainer's losses through the prefetch equal to the losses of
the same batches copied one by one, bit for bit."""

import threading

import numpy as np
import pytest
import torch

from contextaware_poseformer_tpu_torch.data import pipeline
from contextaware_poseformer_tpu_torch.data.synthetic import (
    SyntheticPoseDataset,
)
from contextaware_poseformer_tpu_torch.train import steps, train_h36m
from contextaware_poseformer_tpu_torch.train.loop import Trainer

JOIN_S = 10.0  # the longest a test waits for a thread


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its tiny graphs run op by op,
    and a pool of threads a test worker only contends with the other
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _put(batch):
    return pipeline.to_device(batch, "cpu")


def _dataset(n=22):
    return SyntheticPoseDataset(size=n, image_shape=(16, 12), seed=3)


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_prefetch_yields_the_same_batches_in_order(depth):
    """A padded eval pass (22 items in batches of 4: the last holds 2
    valid rows) through ``device_prefetch`` equals ``to_device`` on each
    host batch, with the same ``valid`` counts."""
    ds = _dataset()

    def host():
        return pipeline.batch_iterator(ds, 4, shuffle=False,
                                       drop_remainder=False, num_workers=2)

    ours = list(pipeline.device_prefetch(host(), _put, depth=depth))
    theirs = [(_put(b), v) for b, v in host()]
    assert [v for _, v in ours] == [v for _, v in theirs] == [4] * 5 + [2]
    for (a, _), (b, _) in zip(ours, theirs):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_prefetch_reraises_a_producer_error():
    def host():
        for batch in pipeline.batch_iterator(_dataset(), 4, shuffle=False,
                                             num_workers=1):
            yield batch
            raise RuntimeError("reader failed")

    it = pipeline.device_prefetch(host(), _put)
    batch, valid = next(it)
    assert valid == 4 and batch.images_u8.shape == (4, 16, 12, 3)
    with pytest.raises(RuntimeError, match="reader failed"):
        next(it)


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "device_prefetch"]


def test_early_stop_leaves_no_thread_blocked():
    """A consumer that takes one batch of an endless stream and stops (as
    ``train_epoch`` at ``max_steps``): closing the generator stops the
    producer, which was blocked on a full queue, and closes the host
    iterator. The whole run has its own time limit."""
    closed = threading.Event()
    batch = next(pipeline.batch_iterator(_dataset(), 4, shuffle=False,
                                         num_workers=1))

    def endless():
        try:
            while True:
                yield batch
        finally:
            closed.set()

    before = _prefetch_threads()
    done = threading.Event()

    def consume():
        it = pipeline.device_prefetch(endless(), _put, depth=2)
        for _ in it:
            break
        it.close()
        done.set()

    worker = threading.Thread(target=consume, daemon=True)
    worker.start()
    worker.join(JOIN_S)
    assert done.is_set() and not worker.is_alive()
    assert closed.wait(JOIN_S)
    assert _prefetch_threads() == before


def _tiny_trainer():
    args = train_h36m.build_argparser().parse_args(
        ["--tiny", "--synthetic", "--device", "cpu", "--batch-size", "2"])
    cfg = train_h36m.make_config(args)
    train_ds, val_ds = train_h36m.make_datasets(cfg, args)
    return Trainer(cfg, train_ds, val_ds, "cpu")


def test_trainer_epoch_through_the_prefetch_keeps_its_losses():
    """The ``--tiny`` Trainer's epoch (2 steps) through ``device_prefetch``
    against the same batches through ``to_device`` one at a time, from the
    same initial state: every step loss and every lifter parameter
    afterwards equal bit for bit; one eval batch too."""
    trainer = _tiny_trainer()
    cfg = trainer.cfg
    a = trainer.init_state(0)
    ours = trainer.train_epoch(a, 0, max_steps=2)["step_losses"]

    b = trainer.init_state(0)
    theirs = []
    for raw, _ in pipeline.batch_iterator(
            trainer.train_ds, cfg.train.batch_size, shuffle=True,
            seed=cfg.train.seed, epoch=0, num_workers=cfg.data.num_workers):
        m = steps.train_step(b, pipeline.to_device(raw, "cpu"), cfg,
                             trainer.task, cfg.train.seed + 1)
        theirs.append(float(m["loss"]))
        if len(theirs) == 2:
            break
    assert ours == theirs and all(np.isfinite(ours))
    for p, q in zip(a.model.lifter.parameters(), b.model.lifter.parameters()):
        assert torch.equal(p, q)

    pred, gt = trainer.predict(a, max_batches=1)
    raw, valid = next(pipeline.batch_iterator(
        trainer.val_ds, cfg.train.batch_size, shuffle=False,
        drop_remainder=False, num_workers=1))
    p2, g2 = steps.eval_step(a.model, pipeline.to_device(raw, "cpu"), cfg,
                             trainer.task)
    np.testing.assert_array_equal(pred, p2[:valid].float().numpy())
    np.testing.assert_array_equal(gt, g2[:valid].float().numpy())
    assert _prefetch_threads() == []


def test_trainer_stages_through_device_prefetch(monkeypatch):
    """``train_epoch`` and ``predict`` take their batches from
    ``device_prefetch``, and close it when they stop early."""
    calls = []
    real = pipeline.device_prefetch

    def spy(host_iter, put, depth=2):
        gen = real(host_iter, put, depth)
        calls.append(gen)
        return gen

    monkeypatch.setattr(pipeline, "device_prefetch", spy)
    trainer = _tiny_trainer()
    state = trainer.init_state(0)
    trainer.train_epoch(state, 0, max_steps=1)
    trainer.predict(state, max_batches=1)
    assert len(calls) == 2
    assert all(g.gi_frame is None for g in calls)  # closed
