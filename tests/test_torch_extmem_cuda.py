"""Card legs of out-of-core training: pinned pages, the device slots of
the page ring reused under eight pages with lookahead 2, and streaming
held bitwise against in-core training and against the CPU.  They need an
NVIDIA GPU and skip without one; run them on the card with
``python -m pytest -q -p no:cacheprovider tests/test_torch_extmem_cuda.py``.

This file imports PyTorch and the port only (the card's machine has no
JAX): the CPU run is the reference here, itself held against xgboost_tpu
by tests/test_torch_extmem_train.py.  Under deterministic_histogram the
models are byte-identical card to CPU and streaming to in-core."""
import json
import time

import numpy as np
import pytest
import torch

import xgboost_tpu_torch as xtt
from xgboost_tpu_torch.data import extmem as tx
from xgboost_tpu_torch.ops import hist_cuda

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="the CUDA kernels run only on a GPU")

DET = {"objective": "binary:logistic", "max_depth": 5, "max_bin": 64,
       "eta": 0.3, "deterministic_histogram": 1}


def _pages(n_pages=8, rows=2048, F=7, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_pages * rows, F)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    X[:, F - 1] = rng.integers(0, 9, size=len(X))
    y = (np.nan_to_num(X[:, 0]) - np.nan_to_num(X[:, 1])
         + 0.4 * (X[:, F - 1] % 2) + 0.3 * rng.normal(size=len(X)) > 0
         ).astype(np.float32)
    types = ["q"] * (F - 1) + ["c"]
    # the last page is short: its slot is refilled with fewer rows
    batches = [{"data": X[i * rows:(i + 1) * rows - (700 if i == n_pages - 1
                                                     else 0)],
                "label": y[i * rows:(i + 1) * rows - (700 if i == n_pages - 1
                                                      else 0)],
                "feature_types": types} for i in range(n_pages)]
    return X, y, batches


class _It(xtt.DataIter):
    def __init__(self, batches):
        super().__init__()
        self.b, self.i = batches, 0

    def reset(self):
        self.i = 0

    def next(self, input_data):
        if self.i >= len(self.b):
            return 0
        input_data(**self.b[self.i])
        self.i += 1
        return 1


def _json(bst) -> str:
    return json.dumps(bst.save_raw_dict())


def _ext(batches, device, **kw):
    return xtt.ExtMemQuantileDMatrix(_It(batches), max_bin=64,
                                     enable_categorical=True, device=device,
                                     compress=False, **kw)


@needs_cuda
def test_card_pages_are_pinned_and_bins_equal_the_cpus():
    _, _, batches = _pages()
    card, cpu = _ext(batches, "cuda"), _ext(batches, "cpu")
    assert all(isinstance(p, torch.Tensor) and p.is_pinned()
               for p in card._pages)
    for a, b in zip(card._pages, cpu._pages):
        assert torch.equal(a, b)


@needs_cuda
def test_ring_slots_are_reused_only_after_their_readers():
    """Eight distinct pages through three slots, each read by a slow
    kernel chain before its slot is released: every read sees its own
    page."""
    rng = np.random.default_rng(1)
    pages = [torch.from_numpy(rng.integers(0, 200, size=(4096, 64)).astype(
        np.uint8)).pin_memory() for _ in range(8)]
    ring = tx.DevicePageRing(torch.device("cuda"), 3, 4096, 64, torch.uint8,
                             staged=False)
    sched = tx.PageScheduler(pages, torch.device("cuda"), lookahead=2,
                             ring=ring)
    w = torch.randn(2048, 2048, device="cuda")
    sums = []
    for j in range(8):
        b = sched.get(j)
        for _ in range(20):  # keep the compute stream busy behind the read
            w = torch.tanh(w @ w * 1e-3)
        sums.append(b.to(torch.int64).sum(dim=0))
        sched.release(j)
    sched.close()
    torch.cuda.synchronize()
    for j, s in enumerate(sums):
        assert torch.equal(s.cpu(), pages[j].to(torch.int64).sum(dim=0))
    ring.close()


@needs_cuda
def test_first_copy_into_a_slot_waits_for_earlier_compute_work():
    """A ring's slots come from the compute stream's memory, which kernels
    enqueued there before the ring may still write: a page's first copy
    into its slot waits for them, and is still pending while they run."""
    rng = np.random.default_rng(2)
    pages = [torch.from_numpy(rng.integers(0, 200, size=(4096, 64)).astype(
        np.uint8)).pin_memory() for _ in range(3)]
    w = torch.randn(2048, 2048, device="cuda")
    torch.cuda.synchronize()
    for _ in range(200):  # tens of ms of compute-stream work
        w = torch.tanh(w @ w * 1e-3)
    ring = tx.DevicePageRing(torch.device("cuda"), 3, 4096, 64, torch.uint8,
                             staged=False)
    sched = tx.PageScheduler(pages, torch.device("cuda"), lookahead=2,
                             ring=ring)
    first = sched.get(0)
    time.sleep(0.002)
    pending = not ring.ready[0].query()  # page 0 took slot 0
    sums = [first.to(torch.int64).sum(dim=0)]
    sched.release(0)
    for j in (1, 2):
        sums.append(sched.get(j).to(torch.int64).sum(dim=0))
        sched.release(j)
    sched.close()
    torch.cuda.synchronize()
    assert pending
    for j, s in enumerate(sums):
        assert torch.equal(s.cpu(), pages[j].to(torch.int64).sum(dim=0))
    ring.close()


@needs_cuda
@pytest.mark.parametrize("prefetch", ["1", "0"])
def test_card_streaming_is_the_cpus_under_eight_pages(prefetch, monkeypatch):
    monkeypatch.setenv("XTB_EXTMEM_PREFETCH_PAGES", "2")
    _, _, batches = _pages()
    params = dict(DET, _extmem_prefetch=prefetch)
    card = _ext(batches, "cuda")
    tx.reset_counters()
    hist_cuda.reset_launches()
    got = xtt.train(params, card, 3, verbose_eval=False, device="cuda")
    c = tx.counters()
    assert hist_cuda.launches["hist_q"] == 3 * 8 * DET["max_depth"]
    assert hist_cuda.launches["hist_f32"] == 0
    page = card._pages[0].numel()
    slots = 3 if prefetch == "1" else 1
    assert c["device_page_bytes_hwm"] <= slots * page
    want = xtt.train(params, _ext(batches, "cpu"), 3, verbose_eval=False,
                     device="cpu")
    assert _json(got) == _json(want)
    np.testing.assert_array_equal(got.predict(card), want.predict(
        _ext(batches, "cpu")))


@needs_cuda
@pytest.mark.parametrize("prefetch", ["1", "0"])
def test_card_staged_disk_pages_are_the_cpus_under_eight_pages(prefetch,
                                                               monkeypatch):
    """Pages spilled to disk (on_host=False) are read and verified on the
    decode pool into the ring's pinned staging buffers and copied to the
    card from there: the same model, byte for byte, as the CPU's."""
    monkeypatch.setenv("XTB_EXTMEM_PREFETCH_PAGES", "2")
    _, _, batches = _pages()
    params = dict(DET, _extmem_prefetch=prefetch)
    card = _ext(batches, "cuda", on_host=False)
    assert all(isinstance(p, tx.DiskPage) for p in card._pages)
    tx.reset_counters()
    hist_cuda.reset_launches()
    got = xtt.train(params, card, 3, verbose_eval=False, device="cuda")
    c = tx.counters()
    assert hist_cuda.launches["hist_q"] == 3 * 8 * DET["max_depth"]
    assert c["xtb_extmem_pages_loaded_total"] >= 3 * 8 * DET["max_depth"]
    slots = 3 if prefetch == "1" else 1
    assert c["device_page_bytes_hwm"] <= slots * card._pages[0].nbytes
    cpu = _ext(batches, "cpu")
    want = xtt.train(params, cpu, 3, verbose_eval=False, device="cpu")
    assert _json(got) == _json(want)
    np.testing.assert_array_equal(got.predict(card), want.predict(cpu))


@needs_cuda
def test_card_streaming_is_the_incore_model_on_the_same_cuts():
    X, y, batches = _pages()
    types = batches[0]["feature_types"]
    keep = np.concatenate([np.arange(i * 2048, (i + 1) * 2048
                                     - (700 if i == 7 else 0))
                           for i in range(8)])
    qd = xtt.QuantileDMatrix(X[keep], label=y[keep], max_bin=64,
                             feature_types=types, device="cuda")
    ext = xtt.ExtMemQuantileDMatrix(_It(batches), max_bin=64, ref=qd,
                                    device="cuda", compress=False)
    # nine categories split by partition: the in-core level fuses the
    # dequantisation into one-hot sums only (ops/split.py _scan_xla)
    a = xtt.train(DET, qd, 3, verbose_eval=False, device="cuda")
    b = xtt.train(DET, ext, 3, verbose_eval=False, device="cuda")
    assert _json(a) == _json(b)
    np.testing.assert_allclose(b.predict(ext), a.predict(qd), atol=1e-6)
