"""The port's streaming input pipeline against the JAX package's, on the CPU:
``LazyImageFolder``, ``get_datasets(streaming=)`` and its threshold, and
``iterate_batches`` with ``prefetch`` and ``local_slice``, on folders of
``.npy`` images (and of PNGs, which both read through PIL)."""

import torch_threads  # noqa: F401 (one torch thread in each test worker)

import threading

import numpy as np
import pytest

from hopvae_tpu import data as jdata
from hopvae_tpu.config import load_config as jax_load_config
from hopvae_torch import data as tdata
from hopvae_torch import load_config

N_FILES, SIZE = 40, 64


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """``{"npy": folder, "png": folder}`` of the same 40 synthetic 64×64
    images (the PNG folder where PIL is present)."""
    images = tdata.synthetic_images(N_FILES, SIZE, seed=3)
    out = {"npy": tmp_path_factory.mktemp("npy")}
    for i, img in enumerate(images):
        np.save(out["npy"] / f"{i:03d}.npy", img)
    try:
        from PIL import Image
    except ImportError:
        return out
    out["png"] = tmp_path_factory.mktemp("png")
    for i, img in enumerate(images):
        Image.fromarray(img).save(out["png"] / f"{i:03d}.png")
    return out


def _configs():
    return jax_load_config("ffhq_64_scaled"), load_config("ffhq_64_scaled")


def _batches(ds, **kw):
    return list(tdata.iterate_batches(ds, 8, shuffle=True, seed=4, **kw))


def test_streaming_splits_and_batches_match_jax(folders):
    """The same files in each split, and the same batches bit for bit, from
    ``get_datasets(streaming=True)`` and from the in-memory split, for each
    folder."""
    jcfg, tcfg = _configs()
    for folder in folders.values():
        _splits_match(jcfg, tcfg, str(folder))


def _splits_match(jcfg, tcfg, folder):
    ours = tdata.get_datasets(tcfg, folder, streaming=True)
    theirs = jdata.get_datasets(jcfg, folder, streaming=True)
    memory = tdata.get_datasets(tcfg, folder, streaming=False)
    for a, b, m in zip(ours, theirs, memory):
        assert isinstance(a, tdata.LazyImageFolder) and isinstance(m, tdata.ArrayDataset)
        assert a.files == b.files and len(a) == len(m)
        for (xa, ya), (xb, yb) in zip(
            tdata.iterate_batches(a, 8, shuffle=True, seed=4, drop_remainder=True),
            jdata.iterate_batches(b, 8, shuffle=True, seed=4, drop_remainder=True),
        ):
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)
        np.testing.assert_array_equal(a.gather(np.arange(len(a)))[0], m.images)
        a.close()


@pytest.mark.parametrize("threshold,streams", [(N_FILES - 1, True), (N_FILES, False)])
def test_automatic_choice_matches_jax(folders, monkeypatch, threshold, streams):
    """Past ``STREAMING_THRESHOLD`` files the folder streams, as in JAX."""
    monkeypatch.setattr(tdata, "STREAMING_THRESHOLD", threshold)
    monkeypatch.setattr(jdata, "STREAMING_THRESHOLD", threshold)
    jcfg, tcfg = _configs()
    ours = tdata.get_datasets(tcfg, str(folders["npy"]))
    theirs = jdata.get_datasets(jcfg, str(folders["npy"]))
    assert [isinstance(d, tdata.LazyImageFolder) for d in ours] == [streams] * 3
    assert [isinstance(d, jdata.LazyImageFolder) for d in theirs] == [streams] * 3


def test_prefetch_and_local_slices(folders):
    """``prefetch=2`` yields what ``prefetch=0`` does, and the pieces of
    ``local_slice`` partition each global batch in order, as JAX's."""
    ds = tdata.LazyImageFolder(tdata.list_image_files(str(folders["npy"])), SIZE)
    jds = jdata.LazyImageFolder(jdata.list_image_files(str(folders["npy"])), SIZE)
    whole = _batches(ds, drop_remainder=True)
    assert len(whole) == N_FILES // 8
    for (a, la), (b, lb) in zip(_batches(ds, drop_remainder=True, prefetch=2), whole):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    pieces = [_batches(ds, drop_remainder=True, prefetch=2, local_slice=(lo, lo + 2)) for lo in range(0, 8, 2)]
    theirs = [list(jdata.iterate_batches(jds, 8, shuffle=True, seed=4, drop_remainder=True, local_slice=(lo, lo + 2)))
              for lo in range(0, 8, 2)]
    for k, (x, _) in enumerate(whole):
        np.testing.assert_array_equal(np.concatenate([p[k][0] for p in pieces]), x)
        for p, q in zip(pieces, theirs):
            np.testing.assert_array_equal(p[k][0], q[k][0])
    with pytest.raises(ValueError, match="drop_remainder"):
        tdata.iterate_batches(ds, 8, shuffle=False, local_slice=(0, 4))
    ds.close()


class _Failing(tdata.ArrayDataset):
    def gather(self, idx):
        if idx[0] >= 16:
            raise OSError("unreadable file")
        return super().gather(idx)


def _new_prefetch_threads(known) -> list:
    """The live ``"prefetch"`` threads that are not in ``known``: this
    test's own, whatever else runs in the process."""
    return [t for t in threading.enumerate() if t.name == "prefetch" and t not in known]


def test_prefetch_raises_in_the_consumer_and_releases_its_thread():
    """An exception in ``gather`` reaches the consumer; a consumer that stops,
    on that exception or early, has joined its thread when it returns."""
    ds = _Failing(np.zeros((40, 2), np.float32), np.zeros(40, np.int64))
    known = set(threading.enumerate())
    with pytest.raises(OSError, match="unreadable"):
        list(tdata.iterate_batches(ds, 8, shuffle=False, prefetch=2))
    assert _new_prefetch_threads(known) == []
    gen = tdata.iterate_batches(tdata.ArrayDataset(ds.images, ds.labels), 2, shuffle=False, prefetch=2)
    next(gen)
    (thread,) = _new_prefetch_threads(known)
    assert thread.is_alive() and thread.daemon
    gen.close()
    assert not thread.is_alive()
    assert _new_prefetch_threads(known) == []
