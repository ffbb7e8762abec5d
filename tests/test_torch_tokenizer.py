"""The port's tokenizers against their oracles, on CPU: its copy of the CLIP
BPE against the JAX package's CLIPTokenizer (HF and open_clip assets, both
pads), and its Llama-3 reader of tokenizer.json against the `tokenizers`
and `transformers` packages on chip_smoke.py's Llama-3-style assets (the
edges where a hand-written reader diverges, and the whole caption prompt),
in ids and in decode."""

import gzip
import sys
from pathlib import Path

import numpy as np
import pytest

from rsvldm_tpu.utils.tokenizer import CLIPTokenizer as JCLIPTokenizer
from rsvldm_tpu_torch.config import REFERENCE_IMG_PROMPT, RefinementConfig
from rsvldm_tpu_torch.models.vlm.generate import llama3_chat_prompt
from rsvldm_tpu_torch.models.vlm.tokenizer import Llama3Tokenizer
from rsvldm_tpu_torch.utils.tokenizer import CLIPTokenizer

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

PROMPT = llama3_chat_prompt(REFERENCE_IMG_PROMPT.format(DEFAULT_IMAGE_TOKEN="<image>"))
EDGES = [
    "1234567 and 12 or 1234", "IT'S, WE'LL, they'RE and it'S", "a\r\nb\n\n c\r\n",
    "word   word", "   leading spaces", "trailing spaces   ", "½ ² Ⅻ ⅓x 3²",
    "café naïve Ångström Œuvre", "地形と土地利用 中文", "emoji 🛰️🌍 ok",
    "tab\there", "under_score and x_1", "!!! ?? ... --", "  \x1c\x1d",
    "<|eot_id|>text<|start_header_id|>user<|end_header_id|>",
    "<|begin_of_text|><|begin_of_text|>", "ſ and K", "",
]


@pytest.fixture(scope="module")
def llama_assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("llava")
    assets = chip_smoke.Llama3Assets([PROMPT])
    assets.write(d)
    return d, assets


@pytest.fixture(scope="module")
def oracles(llama_assets):
    import tokenizers
    from transformers import AutoTokenizer
    d, _ = llama_assets
    return (tokenizers.Tokenizer.from_file(str(d / "tokenizer.json")),
            AutoTokenizer.from_pretrained(str(d), local_files_only=True),
            Llama3Tokenizer.from_dir(d))


@pytest.mark.parametrize("text", EDGES)
def test_llama3_ids_equal_oracles(oracles, text):
    tk, hf, port = oracles
    want = tk.encode(text, add_special_tokens=False).ids
    assert port.encode(text, add_special_tokens=False) == want
    assert hf.encode(text, add_special_tokens=False) == want
    assert port.encode(text, add_special_tokens=True) == \
        tk.encode(text, add_special_tokens=True).ids


def test_llama3_bos_token_id_equals_transformers(oracles, llama_assets, tmp_path):
    """The BOS the plain finetune template leads with: transformers'
    bos_token_id, from tokenizer_config.json, else the template's first
    special token."""
    _, hf, port = oracles
    assert port.bos_token_id == hf.bos_token_id == 128000
    d, _ = llama_assets
    (tmp_path / "tokenizer.json").write_text((d / "tokenizer.json").read_text())
    assert Llama3Tokenizer.from_dir(tmp_path).bos_token_id == 128000


def test_llama3_caption_prompt(oracles, llama_assets):
    """The prompt as the captioner encodes it (split at <image>): equal to
    both oracles and to the assets' own encoding, special tokens mapped to
    128000 / 128006 / 128009."""
    tk, hf, port = oracles
    _, assets = llama_assets
    for chunk in PROMPT.split("<image>"):
        want = tk.encode(chunk, add_special_tokens=False).ids
        assert port.encode(chunk) == want == hf.encode(chunk, add_special_tokens=False)
        assert want == assets.encode(chunk)
    ids = port.encode(PROMPT.split("<image>")[0])
    assert ids[:2] == [128000, 128006] and 128009 in ids and max(ids) < 128256


def test_llama3_ignore_merges(oracles):
    """A piece that is a token whole is one id, where merging by rank alone
    gives others: the filler token " w7" is in the vocabulary but no merge
    makes it (pre-tokenization never yields it from text, so the model is
    asked directly)."""
    _, _, port = oracles
    assert port._bpe("Ġw7") == [port.vocab["Ġw7"]]
    port.ignore_merges = False
    try:
        port.cache.clear()
        assert port._bpe("Ġw7") != [port.vocab["Ġw7"]]
    finally:
        port.ignore_merges = True
        port.cache.clear()


@pytest.mark.parametrize("skip", [True, False])
def test_llama3_decode_equal(oracles, skip):
    tk, hf, port = oracles
    rng = np.random.default_rng(1)
    texts = [PROMPT, *EDGES]
    id_lists = [tk.encode(t, add_special_tokens=False).ids for t in texts]
    id_lists.append(rng.integers(0, 128256, 64).tolist())  # fillers, specials
    id_lists.append([228, 121])  # half a UTF-8 sequence
    for ids in id_lists:
        want = hf.decode(ids, skip_special_tokens=skip)
        assert port.decode(ids, skip_special_tokens=skip) == want
    assert port.decode([128000, 128009]) == ""


def test_llama3_missing_tokenizer_json(tmp_path):
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        Llama3Tokenizer.from_dir(tmp_path)


def test_unicode_classes_exact():
    """\\p{N} holds the Nl / No characters that \\d misses; \\p{L} no digit."""
    import re
    from rsvldm_tpu_torch.models.vlm.tokenizer import unicode_class
    n = re.compile(f"[{unicode_class('N')}]")
    letters = re.compile(f"[{unicode_class('L')}]")
    assert all(n.fullmatch(c) for c in "½²Ⅻ٣7")
    assert not letters.match("½") and letters.fullmatch("ß")


# -------------------------------------------------------------------- CLIP
RP = RefinementConfig()
CLIP_TEXTS = [RP.a_prompt, RP.n_prompt, "a river, 2 bridges & 10 roads!",
              "It's &amp; it'LL    be\nok", "ÉCOLE 建物", ""]


@pytest.fixture(scope="module")
def clip_dirs(tmp_path_factory):
    """HF assets from chip_smoke.ClipAssets, and the same merges written as
    open_clip's bpe_simple_vocab_16e6.txt.gz."""
    hf = tmp_path_factory.mktemp("clip_hf")
    assets = chip_smoke.ClipAssets(CLIP_TEXTS[:2])
    assets.write(hf)
    oc = tmp_path_factory.mktemp("clip_oc")
    lines = ["#version: 0.2"] + [f"{a} {b}" for a, b in assets.merges]
    with gzip.open(oc / "bpe_simple_vocab_16e6.txt.gz", "wt", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return hf, oc, assets


@pytest.mark.parametrize("fmt", ["hf", "open_clip"])
@pytest.mark.parametrize("pad_id", [None, 0])
def test_clip_tokens_equal_jax(clip_dirs, fmt, pad_id):
    d = clip_dirs[0] if fmt == "hf" else clip_dirs[1]
    want = JCLIPTokenizer.from_dir(str(d))(CLIP_TEXTS, pad_id=pad_id)
    got = CLIPTokenizer.from_dir(str(d))(CLIP_TEXTS, pad_id=pad_id)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (len(CLIP_TEXTS), 77)


def test_clip_assets_own_encoding(clip_dirs):
    hf, _, assets = clip_dirs
    tok = CLIPTokenizer.from_dir(str(hf))
    for text in CLIP_TEXTS[:2]:
        assert [tok.sot, *tok.encode(text), tok.eot] == assets.encode(text)
    assert (tok.sot, tok.eot) == (49406, 49407)


def test_clip_missing_assets(tmp_path):
    with pytest.raises(FileNotFoundError):
        CLIPTokenizer.from_dir(str(tmp_path))
