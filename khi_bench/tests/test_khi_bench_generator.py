"""The generator: the same seed gives the same corpus and requests, a
chunk does not depend on how many came before, the attribute model is the
preset's, and the box calibration reaches its target selectivity."""

import numpy as np
import pytest
import torch

from khi_bench import generator, manifest as mf
from khi_bench.tests.util import SEED

M = mf.load()


def small_cfg(name, n=6000, d=48):
    cfg = mf.config(M, name)
    cfg.update(n=n, d=d)
    return cfg


TRAFFIC = {"chunk_requests": 64, "query_step_nn": 1.0}


def corpus_and_stream(name, seed, tag="window"):
    c = generator.make_corpus(small_cfg(name), seed, "cpu")
    boxes = generator.BoxSampler(c.attrs, 0.125, 0.5)
    boxes.calibrate(c.attrs, generator._gen("cpu", seed, "calibrate"),
                    rows=6000, boxes=256)
    vecs = c.vecs.numpy()
    return c, generator.RequestStream(c, vecs, boxes, TRAFFIC, seed, tag)


@pytest.mark.parametrize("name", [c["name"] for c in M["configs"]])
def test_same_seed_same_data(name):
    a, sa = corpus_and_stream(name, SEED)
    b, sb = corpus_and_stream(name, SEED)
    assert torch.equal(a.vecs, b.vecs) and torch.equal(a.attrs, b.attrs)
    assert a.nn_dist == b.nn_dist
    for x, y in zip(sa.next_chunk(), sb.next_chunk()):
        np.testing.assert_array_equal(x, y)
    c, _ = corpus_and_stream(name, SEED + 1)
    assert not torch.equal(a.vecs, c.vecs)


def test_chunks_do_not_depend_on_earlier_draws():
    _, s1 = corpus_and_stream("khi-youtube-1m", 7)
    _, s2 = corpus_and_stream("khi-youtube-1m", 7)
    first = s1.next_chunk()
    second = s1.next_chunk()
    s2.drawn = 1
    np.testing.assert_array_equal(s2.next_chunk()[0], second[0])
    assert not np.array_equal(first[0], second[0])
    _, w = corpus_and_stream("khi-youtube-1m", 7, tag="warmup")
    assert not np.array_equal(w.next_chunk()[0], first[0])


def test_attribute_model_is_the_presets():
    z = torch.randn(20000, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    year = generator.sample_attr("year", z, 0.85, g)
    assert set(year.unique().tolist()) <= set(range(2005, 2025))
    views = generator.sample_attr("lognormal", z, 0.85, g)
    assert float(views.min()) > 0
    # log-views are 1.5 * N(0, 1) + 6
    assert abs(float(views.log().mean()) - 6.0) < 0.1
    uni = generator.sample_attr("uniform", z, 0.3, g)
    assert 0.0 <= float(uni.min()) and float(uni.max()) <= 1.0
    zipf = generator.sample_attr("zipf", z, 0.2, g)
    assert float(zipf.min()) >= 1.0


def test_corpus_is_low_dimensional():
    c = generator.make_corpus(small_cfg("khi-youtube-1m"), 3, "cpu")
    x = c.vecs.double() - c.vecs.double().mean(0)
    s = torch.linalg.svdvals(x)
    energy = (s * s).cumsum(0) / (s * s).sum()
    L = small_cfg("khi-youtube-1m")["vectors"]["latent_dim"]
    assert float(energy[L - 1]) > 0.95
    assert c.nn_dist > 0


@pytest.mark.parametrize("name", [c["name"] for c in M["configs"]])
def test_calibration_reaches_target(name):
    c = generator.make_corpus(small_cfg(name, n=20000, d=48), 5, "cpu")
    boxes = generator.BoxSampler(c.attrs, 0.125, 0.5)
    cal = boxes.calibrate(c.attrs, generator._gen("cpu", 5, "cal"),
                          rows=20000, boxes=512)
    assert 0.9 <= cal["ratio_q"][1] <= 1.1
    # fresh boxes, all rows: the median achieved selectivity is the target
    sigma, pos = boxes.draw(512, torch.Generator().manual_seed(9))
    lo, hi = boxes.bounds(sigma, pos)
    got = generator.BoxSampler.selectivity(c.attrs, lo, hi)
    ratio = (got / sigma).median()
    assert 0.8 <= float(ratio) <= 1.25
    assert float(got.median()) >= 0.125 * 0.8
