"""The benchmark's counting of kernel work and model FLOPs: K1's and K2's
bounds at the shapes PERF.md's kernel table states, K1's launches a
denoiser step read from the reference (106 a miss, 58 a hit), K2's 225
launches a Llama-3-8B decode step."""

import pytest

from harness import counting, manifest

LLAMA3 = {"hidden_size": 4096, "intermediate_size": 14336,
          "num_attention_heads": 32, "num_key_value_heads": 8,
          "num_hidden_layers": 32, "vocab_size": 128256}


def test_k1_bounds():
    assert counting.k1_cost(2, 4096, 4096, 10, 64, False)["bound_s"] * 1e3 == \
        pytest.approx(0.0869, abs=5e-5)
    assert counting.k1_cost(1, 1280, 1280, 32, 128, True)["bound_s"] * 1e3 == \
        pytest.approx(0.0136, abs=5e-5)


def test_k2_decode_step_bound():
    assert counting.k2_step_bound_s(LLAMA3) * 1e3 == pytest.approx(1.19, abs=5e-3)
    assert counting.k2_launches_per_step(LLAMA3) == 225
    q = counting.k2_cost(1, 4096, 4096)
    assert q["bound_s"] * 1e6 == pytest.approx(2.67, abs=5e-3)


def test_valid_pairs():
    assert counting.valid_pairs(4, 4, True) == 10
    assert counting.valid_pairs(4, 6, False) == 24
    assert counting.valid_pairs(3, 5, True) == 3 + 4 + 5


@pytest.fixture(scope="module")
def spec():
    man = manifest.load()
    return manifest.config(man, "rsvldm-mistral-7b")


def test_denoiser_k1_calls(spec):
    dc = counting.denoiser_counts(spec)
    assert len(dc["first"]["k1"]) == 58
    assert len(dc["first"]["k1"]) + len(dc["rest"]["k1"]) == 106
    shapes = {c[:5] for c in dc["first"]["k1"] + dc["rest"]["k1"]}
    assert shapes == {(2, 4096, 4096, 10, 64), (2, 1024, 1024, 20, 64)}


def test_image_counts(spec):
    assert counting.k1_image(spec, 48, 50, 1280)["launches"] == 50 * 58 + 2 * 48 + 32
    k2 = counting.k2_image(spec, 255)
    assert k2["launches"] == 255 * 225 + 1
    assert counting.k2_image(spec, None)["launches"] == 0


def test_decoder_flops_closed_form():
    tc = dict(LLAMA3, vocab_size=1000, num_hidden_layers=1)
    f = counting.decoder_flops(tc, 3, 2)
    d, h, hd = 4096, 32, 128
    lin = d * 4096 + 2 * d * 1024 + 4096 * d + 3 * d * 14336
    assert f == 2.0 * lin * 4 + 4.0 * h * hd * (1 + 2 + 3 + 4) + 2.0 * d * 1000 * 2


def test_image_flops_grow_with_misses(spec):
    all_hits = counting.image_flops(spec, 49, 50, 1250, 256)
    fewer = counting.image_flops(spec, 40, 50, 1250, 256)
    rest = counting.denoiser_counts(spec)["rest"]["flops"]
    assert fewer - all_hits == pytest.approx(9 * rest)
    assert counting.image_flops(spec, 49, 50, None, None) < all_hits
