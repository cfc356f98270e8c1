"""The port's ImageReward stack vs the JAX package, fp32 on the CPU at the
tiny configs: WordPiece ids and masks on a vocabulary the test writes, the
BLIP ViT, the BERT encoder (masked self-attention, cross-attention to the
image tokens, and unmasked), the MLP head and the whole scorer, all loaded
by each package's ``load_imagereward`` from one BLIP-layout checkpoint the
test writes (its ``token_type_embeddings`` folded by both).

The JAX package's ``flax_to_torch`` refuses the ViT's ``cls_token`` and
``pos_embed`` (import-only leaves), so the test writes those two itself.
Tolerance: ATOL 3e-5 / RTOL 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pairwise_sample_optimization_tpu.checkpoints import convert as jconv
from pairwise_sample_optimization_tpu.checkpoints import scorer_loaders as jsl
from pairwise_sample_optimization_tpu.checkpoints import torch_names as jnames
from pairwise_sample_optimization_tpu.data.wordpiece import WordPieceTokenizer as JWordPiece
from pairwise_sample_optimization_tpu.models.bert import BertConfig as JBertConfig
from pairwise_sample_optimization_tpu.models.bert import BertEncoder as JBert
from pairwise_sample_optimization_tpu.models.vit import ViT as JViT
from pairwise_sample_optimization_tpu.models.vit import ViTConfig as JViTConfig
from pairwise_sample_optimization_tpu.rewards.imagereward import ImageRewardMLP as JMLP
from pairwise_sample_optimization_tpu.rewards.imagereward import ImageRewardScorer as JScorer
from pairwise_sample_optimization_tpu.rewards.preprocess import clip_preprocess as j_preprocess
from pairwise_sample_optimization_tpu_torch.checkpoints import load_imagereward
from pairwise_sample_optimization_tpu_torch.data import WordPieceTokenizer
from pairwise_sample_optimization_tpu_torch.models import BertConfig, ViTConfig
from pairwise_sample_optimization_tpu_torch.rewards import ImageRewardScorer

ATOL, RTOL = 3e-5, 2e-4
B, TEXT = 3, 12

VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "an", "photo", "of", "the", "cat", "dog",
          "astronaut", "riding", "horse", "un", "##believ", "##able", "red", "fox", "in", "snow",
          "##s", "##ing", "ca", "##t", "3", "##d", "café"]
         + list(".,!?;:()[]{}\"'`~@#$%^&*+=|\\/<>-") + [chr(c) for c in range(97, 123)]
         + ["##" + chr(c) for c in range(97, 123)])
PROMPTS = [
    "a photo of the cat", "An Astronaut riding a horse!", "unbelievable", "zebra zzz-qq",
    "A red fox, in the snow (3d render)...", "the cats' dogs riding horses", "café naïve résumé",
    "   spaces\tand\nnewlines  ", "", "a " * 40 + "cat", "mixed-case: CaT; DoG? [snow]",
    "emoji 🐱 and 日本", "x@y#z$%^&*+=|\\/<>`~",
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The shapes here are tiny: one intra-op thread is as fast, and does not
    oversubscribe the CPU when test files run in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


@pytest.mark.parametrize("context_length", [35, 8])
def test_wordpiece_matches_jax(tmp_path, context_length):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    jt = JWordPiece(str(path), context_length=context_length)
    tt = WordPieceTokenizer(str(path), context_length=context_length)
    for p in PROMPTS:
        assert tt.encode(p) == jt.encode(p), p
    got, want = tt(PROMPTS), jt(PROMPTS)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert tt.vocab_size == jt.vocab_size and (tt.cls, tt.sep, tt.pad) == (jt.cls, jt.sep, jt.pad)
    with pytest.raises(ValueError, match="missing"):
        WordPieceTokenizer(vocab=["[PAD]", "[CLS]", "[SEP]"])
    with pytest.raises(FileNotFoundError):
        WordPieceTokenizer(str(tmp_path / "missing.txt"))


def _fill(tree, rng):
    """Random values in a flax tree's shapes: kernels gaussian with std
    1/sqrt(fan_in), norms near identity, embeddings and biases small."""

    def leaf(path, a):
        name, shape = path[-1].key, a.shape
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name == "bias" or len(shape) < 2 or "embedding" in name:
            std = 0.02 if name != "bias" else 0.05
        else:
            std = 1.0 / np.sqrt(np.prod(shape[:-1]))
        return (rng.standard_normal(shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module", params=["bert_level", "flat"])
def checkpoint(request, tmp_path_factory):
    """A BLIP-layout ImageReward checkpoint (``.pt``) from random JAX
    trees at the tiny configs, loaded into a JAX scorer and the port's by
    each package's ``load_imagereward``. ``bert_level``: the text encoder's
    keys under ``blip.text_encoder.bert.`` (both layouts occur)."""
    rng = np.random.default_rng(0)
    vcfg, bcfg = JViTConfig.tiny(), JBertConfig.tiny()
    n_img = (vcfg.image_size // vcfg.patch_size) ** 2 + 1
    abstract = {
        "vit": jax.eval_shape(JViT(vcfg).init, jax.random.key(0),
                              jnp.zeros((1, vcfg.image_size, vcfg.image_size, 3))),
        "bert": jax.eval_shape(JBert(bcfg).init, jax.random.key(0), jnp.zeros((1, 4), jnp.int32),
                               jnp.ones((1, 4), jnp.int32), jnp.zeros((1, n_img, vcfg.width))),
        "mlp": jax.eval_shape(JMLP().init, jax.random.key(0), jnp.zeros((1, bcfg.hidden))),
    }
    params = {k: _fill(v["params"], rng) for k, v in abstract.items()}
    vit = {k: v for k, v in params["vit"].items()
           if k not in ("class_embedding", "position_embedding")}
    text = "blip.text_encoder." + ("bert." if request.param == "bert_level" else "")
    sd = {
        **{"blip.visual_encoder." + k: v for k, v in
           jconv.flax_to_torch(vit, jnames.blip_vit_param_map).items()},
        "blip.visual_encoder.cls_token": params["vit"]["class_embedding"][None, None],
        "blip.visual_encoder.pos_embed": params["vit"]["position_embedding"][None],
        **{text + k: v for k, v in
           jconv.flax_to_torch(params["bert"], jnames.blip_bert_param_map).items()},
        text + "embeddings.token_type_embeddings.weight":
            (rng.standard_normal((2, bcfg.hidden)) * 0.02).astype(np.float32),
        text + "embeddings.position_ids": np.arange(bcfg.max_positions)[None],  # read past
        **{"mlp." + k: v for k, v in
           jconv.flax_to_torch(params["mlp"], jnames.sequential_mlp_param_map).items()},
    }
    path = tmp_path_factory.mktemp("imagereward") / "ImageReward.pt"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    jvit, jbert, jmlp = jsl.load_imagereward(str(path), abstract["vit"], abstract["bert"],
                                             abstract["mlp"])
    js = JScorer(vit_variables=jvit, bert_variables=jbert, mlp_variables=jmlp,
                 vit_config=vcfg, bert_config=bcfg)
    port = load_imagereward(str(path), ImageRewardScorer.random(ViTConfig.tiny(),
                                                                BertConfig.tiny(), device="cpu"))
    return js, port, sd, text


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, (B, 40, 40, 3)).astype(np.float32)
    ids = rng.integers(4, 1000, (B, TEXT)).astype(np.int32)
    mask = np.ones((B, TEXT), np.int32)
    for i, n in enumerate((TEXT, 7, 3)):  # padded rows, as the tokenizer pads
        ids[i, 0], ids[i, n - 1], ids[i, n:], mask[i, n:] = 2, 3, 0, 0
    return images, ids, mask


def test_load_imagereward_folds_the_token_types_as_jax(checkpoint):
    js, port, sd, text = checkpoint
    pos = port.bert.embeddings.position_embeddings.weight.detach()
    want = js.bert_variables["params"]["position_embeddings"]
    assert torch.equal(pos, torch.from_numpy(np.array(want)))
    np.testing.assert_array_equal(
        pos.numpy(), sd[text + "embeddings.position_embeddings.weight"]
        + sd[text + "embeddings.token_type_embeddings.weight"][0])
    assert torch.equal(port.vit.cls_token, torch.from_numpy(sd["blip.visual_encoder.cls_token"]))
    assert torch.equal(port.mlp.layers[7].weight, torch.from_numpy(sd["mlp.layers.7.weight"]))


def test_vit_matches_jax(checkpoint):
    js, port, _, _ = checkpoint
    images, _, _ = _inputs()
    pixels = j_preprocess(jnp.asarray(images), js.vit_config.image_size)
    want = js.vit.apply(js.vit_variables, pixels)
    with torch.no_grad():
        got = port.vit(torch.from_numpy(np.array(pixels)).permute(0, 3, 1, 2).contiguous())
    assert got.shape == (B, 17, 32)
    _close(got, want)


@pytest.mark.parametrize("mode", ["masked_with_cross", "masked_without_context",
                                  "unmasked_with_cross"])
def test_bert_matches_jax(checkpoint, mode):
    """Masked self-attention (the plain path) with and without the
    cross-attention to image tokens, and unmasked (the flash-attention
    seam for both)."""
    js, port, _, _ = checkpoint
    _, ids, mask = _inputs()
    ctx = np.random.default_rng(2).standard_normal((B, 17, 32)).astype(np.float32)
    m = None if mode.startswith("unmasked") else mask
    c = None if mode == "masked_without_context" else ctx
    want = js.bert.apply(js.bert_variables, jnp.asarray(ids),
                         None if m is None else jnp.asarray(m),
                         None if c is None else jnp.asarray(c))
    with torch.no_grad():
        got = port.bert(torch.from_numpy(ids).long(), None if m is None else torch.from_numpy(m),
                        None if c is None else torch.from_numpy(c))
    _close(got, want)


def test_mlp_head_matches_jax(checkpoint):
    js, port, _, _ = checkpoint
    x = np.random.default_rng(3).standard_normal((B, 32)).astype(np.float32)
    with torch.no_grad():
        got = port.mlp(torch.from_numpy(x))
    _close(got, js.mlp.apply(js.mlp_variables, jnp.asarray(x)))


def test_scorer_matches_jax(checkpoint):
    js, port, _, _ = checkpoint
    images, ids, mask = _inputs(seed=4)
    want = js.score(jnp.asarray(images), jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = port.score(torch.from_numpy(images), torch.from_numpy(ids).long(),
                         torch.from_numpy(mask).long())
    assert got.shape == (B,) and got.dtype == torch.float32
    _close(got, want)
    # a padded token's id does not change the scores (the self-attention mask)
    ids2 = ids.copy()
    ids2[2, -1] = 7
    with torch.no_grad():
        again = port.score(torch.from_numpy(images), torch.from_numpy(ids2).long(),
                           torch.from_numpy(mask).long())
    _close(again, got, atol=1e-6, rtol=1e-6)


def test_loader_raises_on_a_missing_weight(checkpoint, tmp_path):
    _, _, sd, _ = checkpoint
    bad = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()
           if k != "blip.visual_encoder.norm.weight"}
    with pytest.raises(KeyError, match="missing"):
        load_imagereward(bad, ImageRewardScorer.random(ViTConfig.tiny(), BertConfig.tiny(),
                                                       device="cpu"))

