"""The port's ``data.reader.prefetch`` (JAX ``reader.py:411-441``) and the
trainer's use of it: items in order and by identity, the worker's
exception raised in the consumer, a worker stopped within 1 s when its
consumer stops early or fails, both trainer loops drawing through it, and
an epoch with prefetch logging exactly what the same epoch with the
loaders iterated bare logs (tolerance 0: the same batches in the same
order give the same arithmetic)."""

import threading
import time

import pytest

from _torch_parity import one_torch_thread  # noqa: F401  (autouse)
from psignn_tpu.data.reader import prefetch as jax_prefetch
from psignn_tpu_torch.data.generate import generate_data
from psignn_tpu_torch.data.reader import (GraphLoader, load_dataset, prefetch,
                                          split_dataset)
from psignn_tpu_torch.models import PsignnConfig
from psignn_tpu_torch.train import TrainConfig, Trainer
from psignn_tpu_torch.train import trainer as trainer_mod

FAST = dict(fw_tol=1e-3, fw_thres=25, bw_tol=1e-5, bw_thres=25)


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "prefetch" and t.is_alive()]


def _wait_no_worker(limit_s: float = 1.0) -> bool:
    t0 = time.perf_counter()
    while _prefetch_threads():
        if time.perf_counter() - t0 > limit_s:
            return False
        time.sleep(0.01)
    return True


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_items_in_order_and_by_identity(depth):
    items = [object() for _ in range(17)]
    got = list(prefetch(iter(items), depth=depth))
    assert len(got) == len(items)
    assert all(a is b for a, b in zip(got, items))
    # JAX's prefetch gives the same sequence
    assert all(a is b for a, b in zip(jax_prefetch(iter(items), depth),
                                      items))
    assert _wait_no_worker()


def test_worker_exception_reaches_the_consumer():
    def source():
        yield from range(3)
        raise ValueError("bad batch")

    seen = []
    with pytest.raises(ValueError, match="bad batch"):
        for x in prefetch(source()):
            seen.append(x)
    assert seen == [0, 1, 2]
    assert _wait_no_worker()


def test_closed_generator_stops_its_worker():
    built = []

    def endless():
        i = 0
        while True:
            built.append(i)
            yield i
            i += 1

    gen = prefetch(endless(), depth=2)
    assert [next(gen), next(gen)] == [0, 1]
    assert _prefetch_threads()
    gen.close()
    assert _wait_no_worker(1.0)
    n = len(built)
    time.sleep(0.1)
    assert len(built) == n          # nothing is built after the stop


def test_failing_consumer_stops_its_worker():
    def step(x):
        if x == 3:
            raise RuntimeError("step failed")

    with pytest.raises(RuntimeError, match="step failed"):
        for x in prefetch(iter(range(1000)), depth=2):
            step(x)
    assert _wait_no_worker(1.0)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data"))
    generate_data(path, n_mesh=2, n_samples=5, hsize=0.25, seed=21,
                  verbose=False)
    return path


def _epoch(data_dir, path_results):
    train, val, _ = split_dataset(load_dataset(data_dir))
    lt = GraphLoader(train, batch_size=3, shuffle=True, seed=0,
                     device="cpu")
    lv = GraphLoader(val, batch_size=3, device="cpu")
    cfg = TrainConfig(model_cfg=PsignnConfig(**FAST), max_epochs=1,
                      path_results=str(path_results), device="cpu")
    tr = Trainer(cfg, lt, lv)
    tr.train_model()
    with open(path_results / "logs" / "train_metrics.csv") as f:
        log = [line for line in f.read().splitlines()
               if "took current epoch" not in line]
    return tr, lt, lv, log


def test_trainer_loops_draw_through_prefetch(tmp_path, data_dir,
                                             monkeypatch):
    calls = []

    def counted(iterable, depth=2):
        calls.append(iterable)
        return prefetch(iterable, depth)

    monkeypatch.setattr(trainer_mod, "prefetch", counted)
    tr, lt, lv, _ = _epoch(data_dir, tmp_path)
    assert calls == [lt, lv]          # the train loop, then validation
    assert len(tr.hist_train["loss"]) == len(tr.hist_val["loss"]) == 1


def test_prefetched_epoch_logs_the_bare_epoch(tmp_path, data_dir,
                                              monkeypatch):
    _, _, _, with_prefetch = _epoch(data_dir, tmp_path / "prefetch")
    monkeypatch.setattr(trainer_mod, "prefetch",
                        lambda iterable, depth=2: iter(iterable))
    tr, _, _, bare = _epoch(data_dir, tmp_path / "bare")
    assert with_prefetch == bare
    assert any("Validation Epoch 0" in line for line in bare)
    assert _wait_no_worker()
