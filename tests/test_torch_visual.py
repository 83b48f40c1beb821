"""The port's visual encoders, CLIP towers, import shims and tokenizer
against the JAX package: the same numpy inputs and the JAX trees carried over
by ``convert.visual_params_from_flax``, float32 on both sides.  Outputs agree
to 1e-5 of their scale (sums in another order); converted trees come back
through ``tree_to_flax`` exactly; the shims give equal trees."""

import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffbinaural_tpu.cli.common import visual_apply_fn as jax_visual_apply_fn
from diffbinaural_tpu.core import checkpoint as jax_ckpt
from diffbinaural_tpu.core.config import CLIPConfig as JaxCLIPConfig
from diffbinaural_tpu.core.config import CLIPTextConfig as JaxCLIPTextConfig
from diffbinaural_tpu.data.clip_tokenizer import SimpleTokenizer as JaxTokenizer
from diffbinaural_tpu.models import visual as jv
from diffbinaural_tpu.models.attention import MaskedAttention as JaxMaskedAttention
from diffbinaural_tpu_torch.cli.common import visual_apply_fn
from diffbinaural_tpu_torch.convert import tree_to_flax, visual_params_from_flax
from diffbinaural_tpu_torch.core import checkpoint
from diffbinaural_tpu_torch.core.config import CLIPConfig, CLIPTextConfig
from diffbinaural_tpu_torch.data.clip_tokenizer import SimpleTokenizer
from diffbinaural_tpu_torch.models import visual as tv
from diffbinaural_tpu_torch.models.attention import MaskedAttention

from _torch_port_util import one_torch_thread  # noqa: F401 (autouse fixture)
from _torch_port_util import random_params, t, to_numpy_tree

TOL = 1e-5  # of the output's scale
TINY = dict(image_size=32, patch_size=16, width=64, layers=2, heads=2)
TINY_TEXT = dict(vocab_size=64, context_length=8, width=32, layers=2, heads=4)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _params(module, rng, *args, **kwargs):
    """Random flax parameters, ``FrozenBN`` variances made positive."""
    params = random_params(module, rng, *args, **kwargs)
    return to_numpy_tree(jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.abs(leaf) + 0.5
        if getattr(path[-1], "key", None) == "var" else leaf, params))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _load(module, tree):
    """Load a flax tree into ``module`` and hold ``tree_to_flax`` of its
    state_dict to the tree, leaf for leaf."""
    module.load_state_dict(visual_params_from_flax(tree), strict=True)
    back, want = _flat(tree_to_flax(module.state_dict())), _flat(
        tree["params"])
    assert set(back) == set(want)
    for name, value in want.items():
        np.testing.assert_array_equal(back[name], value, err_msg=name)
    return module.eval()


def _frames(b=2, time=2, n=3, hw=32, seed=0):
    """Frames, 2-D and 3-D positions, and a mask (True = invalid): the last
    source padded everywhere, and every source of sample 1's frame 1."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 3, time, n, hw, hw)).astype(np.float32)
    pos2 = rng.uniform(-1, 1, (b, time, n, 2)).astype(np.float32)
    pos3 = rng.uniform(-1, 1, (b, time, n, 3)).astype(np.float32)
    mask = np.zeros((b, time, n), bool)
    mask[:, :, -1] = True
    mask[1, time - 1] = True
    return x, pos2, pos3, mask


# ------------------------------------------------------ the encoder family

ENCODERS = [("clip", {}), ("clip_pos", {}), ("clip_pos2d", {}),
            ("clip_pos2d_concat", {}), ("clip_pos2d_enhanced", {}),
            ("clip_pos2d_enhanced", {"temporal_pool": "attn",
                                     "use_time_pe": False}),
            ("resnet18", {})]


@pytest.mark.parametrize("arch,kwargs", ENCODERS,
                         ids=[a + ("_attn" if k else "") for a, k in ENCODERS])
def test_encoder_matches_jax(arch, kwargs):
    """Each registry entry through ``visual_apply_fn`` on both sides (the
    routing by family included): frames (2, 3, 2, 3, 32, 32) with padded
    sources and one fully padded frame; the tiny tower of the JAX tests."""
    x, pos2, pos3, mask = _frames()
    clip = {} if arch == "resnet18" else {"clip": JaxCLIPConfig(**TINY)}
    net = jv.build_visual(arch, **clip, **kwargs)
    args = {"clip": (x.mean(3),), "resnet18": (x.mean(3),),
            "clip_pos": (x, pos3, mask)}.get(arch, (x, pos2, mask))
    tree = _params(net, np.random.default_rng(1), *map(jnp.asarray, args))
    want = jax.jit(jax_visual_apply_fn(net, arch))(
        tree, *map(jnp.asarray, (x, pos2, mask, pos3)))

    clip_t = {} if arch == "resnet18" else {"clip": CLIPConfig(**TINY)}
    port = tv.build_visual(arch, device="cpu", **clip_t, **kwargs)
    assert type(port) is tv.ENCODER_REGISTRY[arch] and not port.training
    _load(port, tree)
    with torch.no_grad():
        got = visual_apply_fn(port, arch)(t(x), t(pos2), t(mask), t(pos3))
    assert got.shape == (2, 512)
    _close(got, want)


def test_visual_apply_fn_refuses_another_family():
    net = tv.ClipPos2D(clip=CLIPConfig(**TINY))
    with pytest.raises(ValueError, match="clip_pos"):
        visual_apply_fn(net, "clip_pos")


def test_build_visual_is_seeded_and_in_eval_mode():
    a, b = (tv.build_visual("clip", seed=3, device="cpu",
                            clip=CLIPConfig(**TINY)) for _ in range(2))
    c = tv.build_visual("clip", seed=4, device="cpu", clip=CLIPConfig(**TINY))
    assert not a.training and all(p.device.type == "cpu"
                                  for p in a.parameters())
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0)
    assert not torch.equal(sa["clip.proj"], sc["clip.proj"])
    # the JAX initialisers' scales: N(0, 1/width) for the raw CLIP leaves
    np.testing.assert_allclose(sa["clip.positional_embedding"].std().item(),
                               64**-0.5, rtol=0.2)
    with pytest.raises(ValueError, match="arch_frame"):
        tv.build_visual("vit", device="cpu")


def test_frozen_trunk_gets_no_gradient():
    """The tower runs without autograd (the JAX package's stop_gradient):
    none of its leaves gets a gradient; the head's do."""
    x, pos2, _, mask = _frames(time=1, n=2, seed=2)
    net = tv.build_visual("clip_pos2d", device="cpu", clip=CLIPConfig(**TINY))
    net(t(x), t(pos2), t(mask)).square().sum().backward()
    tower = {k: p.grad for k, p in net.named_parameters()
             if k.startswith("clip.")}
    head = {k: p.grad for k, p in net.named_parameters()
            if not k.startswith("clip.")}
    assert len(tower) > 20 and all(g is None for g in tower.values())
    assert all(g is not None for g in head.values())
    assert sum(bool(g.abs().max() > 0) for g in head.values()) > 20


# ------------------------------------------------------- the shared pieces


def _attn_inputs(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((3, 4, 32)).astype(np.float32)
    kv = rng.standard_normal((3, 5, 32)).astype(np.float32)
    pad = np.zeros((3, 5), bool)
    pad[0, 3:] = True
    pad[2] = True  # every key padded
    return q, kv, pad


def test_masked_attention_matches_jax():
    """True = a valid key; a row with none gets uniform weights."""
    x, _, pad = _attn_inputs()
    valid = ~pad[:, :4]
    jm = JaxMaskedAttention(32, heads=4, dim_head=8)
    tree = _params(jm, np.random.default_rng(3), jnp.asarray(x),
                   jnp.asarray(valid))
    want = jm.apply(tree, jnp.asarray(x), mask=jnp.asarray(valid))
    port = _load(MaskedAttention(32, heads=4, dim_head=8), tree)
    _close(port(t(x), t(valid)), want)
    _close(port(t(x)), jm.apply(tree, jnp.asarray(x)))


def test_multi_head_attention_with_all_padded_rows():
    q, kv, pad = _attn_inputs(seed=1)
    jm = jv.MultiHeadAttention(32, 4)
    args = tuple(map(jnp.asarray, (q, kv, kv)))
    tree = _params(jm, np.random.default_rng(4), *args)
    want = jm.apply(tree, *args, key_padding_mask=jnp.asarray(pad))
    port = _load(tv.MultiHeadAttention(32, 4), tree)
    got = port(t(q), t(kv), t(kv), key_padding_mask=t(pad))
    _close(got, want)
    # the all-padded row: uniform weights over the values, not NaN
    with torch.no_grad():
        uniform = port.out_proj(port.v_proj(t(kv[2])).mean(dim=0))
    torch.testing.assert_close(got[2], uniform.expand(4, -1), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("norm_first", [False, True])
def test_transformer_encoder_matches_jax(norm_first):
    """Post-norm (the default) and pre-norm (the Enhanced encoder), two
    layers, with a key-padding mask holding an all-padded row."""
    _, kv, pad = _attn_inputs(seed=2)
    jm = jv.TransformerEncoder(2, 32, 4, 64, norm_first=norm_first)
    tree = _params(jm, np.random.default_rng(5), jnp.asarray(kv))
    want = jm.apply(tree, jnp.asarray(kv), jnp.asarray(pad))
    port = _load(tv.TransformerEncoder(2, 32, 4, 64, norm_first=norm_first),
                 tree)
    _close(port(t(kv), t(pad)), want)


def test_encoder_layer_gelu_is_the_tanh_approximation():
    _, kv, _ = _attn_inputs(seed=3)
    jm = jv.TransformerEncoderLayer(32, 4, 64, activation="gelu")
    tree = _params(jm, np.random.default_rng(6), jnp.asarray(kv))
    port = _load(tv.TransformerEncoderLayer(32, 4, 64, activation="gelu"),
                 tree)
    _close(port(t(kv)), jm.apply(tree, jnp.asarray(kv)))


def test_set_aggregation_matches_jax():
    """A frame with no valid source returns ``null_embed``."""
    _, kv, pad = _attn_inputs(seed=4)
    jm = jv.SetTransformerAggregation(emb_dim=32, num_heads=4)
    tree = _params(jm, np.random.default_rng(7), jnp.asarray(kv),
                   jnp.asarray(pad))
    want = jm.apply(tree, jnp.asarray(kv), jnp.asarray(pad))
    port = _load(tv.SetTransformerAggregation(32, 4), tree)
    got = port(t(kv), t(pad))
    _close(got, want)
    torch.testing.assert_close(got[2], port.null_embed[0], rtol=0, atol=0)


def test_attentive_pool_matches_jax():
    """A row with every step masked pools to zeros (NaN weights zeroed)."""
    rng = np.random.default_rng(8)
    seq = rng.standard_normal((3, 4, 16)).astype(np.float32)
    mask = np.zeros((3, 4), bool)
    mask[0, 1] = True
    mask[2] = True
    jm = jv.AttentiveTemporalPool(16)
    tree = _params(jm, rng, jnp.asarray(seq), jnp.asarray(mask))
    want = jm.apply(tree, jnp.asarray(seq), jnp.asarray(mask))
    port = _load(tv.AttentiveTemporalPool(16), tree)
    got = port(t(seq), t(mask))
    _close(got, want)
    assert not got[2].any()


def test_time_encoding_equals_jax():
    np.testing.assert_array_equal(tv.sinusoidal_position_encoding(9, 16),
                                  jv.sinusoidal_position_encoding(9, 16))


# ------------------------------------------------------------ CLIP towers


def _tokens():
    tokens = np.zeros((3, 8), np.int32)
    for row, n in enumerate((3, 6, 8)):
        tokens[row, 0] = 62
        tokens[row, 1:n - 1] = np.arange(1, n - 1) * 7 % 60
        tokens[row, n - 1] = 63  # end of text: the largest id
    return tokens


def test_clip_model_matches_jax():
    """Both towers (the text tower's causal mask and end-of-text read at
    rows of 3, 6 and 8 tokens), ``logit_scale``, the scaled cosine logits
    both ways."""
    images = np.random.default_rng(10).standard_normal(
        (2, 3, 32, 32)).astype(np.float32)
    tokens = _tokens()
    jm = jv.CLIPModel(JaxCLIPConfig(**TINY), JaxCLIPTextConfig(**TINY_TEXT))
    tree = _params(jm, np.random.default_rng(11), jnp.asarray(images),
                   jnp.asarray(tokens))
    want = jax.jit(lambda p, im, tk: (
        *jm.apply(p, im, tk), jm.apply(p, im, method=jm.encode_image),
        jm.apply(p, tk, method=jm.encode_text)))(
            tree, jnp.asarray(images), jnp.asarray(tokens))
    port = _load(tv.CLIPModel(CLIPConfig(**TINY), CLIPTextConfig(**TINY_TEXT)),
                 tree)
    got = port(t(images), t(tokens))
    assert got[0].shape == (2, 3)
    _close(got[0], want[0])
    _close(got[1], want[1])
    _close(port.encode_image(t(images)), want[2])
    _close(port.encode_text(t(tokens)), want[3])


# ------------------------------------------------------ the import shims


def _openai_clip_sd(rng, vision=TINY, text=TINY_TEXT):
    """A state dict with OpenAI CLIP's names and shapes, random values."""
    sd = {}

    def add(name, *shape):
        sd[name] = torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32))

    def blocks(prefix, width, layers):
        for i in range(layers):
            b = f"{prefix}transformer.resblocks.{i}"
            add(f"{b}.attn.in_proj_weight", 3 * width, width)
            add(f"{b}.attn.in_proj_bias", 3 * width)
            add(f"{b}.attn.out_proj.weight", width, width)
            add(f"{b}.attn.out_proj.bias", width)
            for ln in ("ln_1", "ln_2"):
                add(f"{b}.{ln}.weight", width)
                add(f"{b}.{ln}.bias", width)
            add(f"{b}.mlp.c_fc.weight", 4 * width, width)
            add(f"{b}.mlp.c_fc.bias", 4 * width)
            add(f"{b}.mlp.c_proj.weight", width, 4 * width)
            add(f"{b}.mlp.c_proj.bias", width)

    w, p = vision["width"], vision["patch_size"]
    grid = (vision["image_size"] // p) ** 2
    add("visual.conv1.weight", w, 3, p, p)
    add("visual.class_embedding", w)
    add("visual.positional_embedding", grid + 1, w)
    for ln in ("ln_pre", "ln_post"):
        add(f"visual.{ln}.weight", w)
        add(f"visual.{ln}.bias", w)
    add("visual.proj", w, 512)
    blocks("visual.", w, vision["layers"])
    tw = text["width"]
    add("token_embedding.weight", text["vocab_size"], tw)
    add("positional_embedding", text["context_length"], tw)
    add("ln_final.weight", tw)
    add("ln_final.bias", tw)
    add("text_projection", tw, 512)
    add("logit_scale")
    blocks("", tw, text["layers"])
    return sd


def _torchvision_resnet18_sd(rng):
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = torch.from_numpy(
            rng.standard_normal((cout, cin, k, k)).astype(np.float32))

    def bn(name, c):
        for leaf in ("weight", "bias", "running_mean"):
            sd[f"{name}.{leaf}"] = torch.from_numpy(
                rng.standard_normal(c).astype(np.float32))
        sd[f"{name}.running_var"] = torch.from_numpy(
            rng.uniform(0.5, 2.0, c).astype(np.float32))
        sd[f"{name}.num_batches_tracked"] = torch.tensor(7)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for i, (f, s) in enumerate(tv.RESNET18_PLAN):
        src = f"layer{i // 2 + 1}.{i % 2}"
        conv(f"{src}.conv1", f, cin, 3)
        bn(f"{src}.bn1", f)
        conv(f"{src}.conv2", f, f, 3)
        bn(f"{src}.bn2", f)
        if s != 1 or cin != f:
            conv(f"{src}.downsample.0", f, cin, 1)
            bn(f"{src}.downsample.1", f)
        cin = f
    sd["fc.weight"] = torch.zeros(1000, 512)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for name, value in want.items():
        assert got[name].dtype == value.dtype, name
        np.testing.assert_array_equal(got[name], value, err_msg=name)


def test_clip_shims_match_jax(tmp_path):
    """``import_torch_clip{_vision,_text,}`` on one OpenAI-named state dict:
    the port's trees equal the JAX shims'; they load into the port's towers
    by ``visual_params_from_flax`` with every name matched; a file works as
    the mapping does."""
    sd = _openai_clip_sd(np.random.default_rng(12))
    full = checkpoint.import_torch_clip(sd)
    _assert_trees_equal(full, jax_ckpt.import_torch_clip(sd))
    vision = checkpoint.import_torch_clip_vision(sd)
    _assert_trees_equal(vision, jax_ckpt.import_torch_clip_vision(sd))
    bare = {k[len("visual."):]: v for k, v in sd.items()
            if k.startswith("visual.")}
    _assert_trees_equal(checkpoint.import_torch_clip_vision(bare), vision)
    text_sd = {k: v for k, v in sd.items() if not k.startswith("visual.")}
    _assert_trees_equal(checkpoint.import_torch_clip_text(text_sd),
                        jax_ckpt.import_torch_clip_text(text_sd))
    model = tv.CLIPModel(CLIPConfig(**TINY), CLIPTextConfig(**TINY_TEXT))
    model.load_state_dict(visual_params_from_flax(full), strict=True)
    torch.testing.assert_close(model.visual.resblock_1.attn.k_proj.weight,
                               sd["visual.transformer.resblocks.1.attn."
                                  "in_proj_weight"][64:128])
    torch.save(sd, tmp_path / "clip.pt")
    _assert_trees_equal(checkpoint.import_torch_clip(str(tmp_path / "clip.pt")),
                        full)


def test_resnet18_shims_match_jax(tmp_path):
    """``import_torch_resnet18``, ``is_torchvision_resnet18_sd`` and
    ``graft_resnet18_trunk`` on torchvision names: equal to the JAX shims'
    trees; the trunk loads into ``ResnetEncoder.features``."""
    sd = _torchvision_resnet18_sd(np.random.default_rng(13))
    trunk = checkpoint.import_torch_resnet18(sd)
    _assert_trees_equal(trunk, jax_ckpt.import_torch_resnet18(sd))
    assert checkpoint.is_torchvision_resnet18_sd(sd)
    clip_sd = _openai_clip_sd(np.random.default_rng(14))
    assert not checkpoint.is_torchvision_resnet18_sd(clip_sd)
    torch.save(sd, tmp_path / "r18.pth")
    (tmp_path / "junk.pth").write_bytes(b"not a checkpoint")
    for path, want in ((tmp_path / "r18.pth", True),
                       (tmp_path / "junk.pth", False),
                       (tmp_path / "missing.pth", False)):
        assert checkpoint.is_torchvision_resnet18_sd(str(path)) is want
        assert jax_ckpt.is_torchvision_resnet18_sd(str(path)) is want

    encoder = tv.ResnetEncoder()
    frame = {"params": tree_to_flax(encoder.state_dict())}
    grafted = checkpoint.graft_resnet18_trunk(frame, sd)
    _assert_trees_equal(grafted, jax_ckpt.graft_resnet18_trunk(frame, sd))
    assert grafted["params"]["encoder"] is frame["params"]["encoder"]
    encoder.load_state_dict(visual_params_from_flax(grafted), strict=True)
    torch.testing.assert_close(encoder.features.block_2.down_bn.var,
                               sd["layer2.0.downsample.1.running_var"])
    torch.testing.assert_close(encoder.features.block_7.bn2.weight,
                               sd["layer4.1.bn2.weight"])


# ----------------------------------------------------------- the tokenizer

MERGES = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o</w>")]
TEXTS = ["hello", "Hello  WORLD!", "a dog's 3 bells &amp; whistles",
         "<|startoftext|>hi<|endoftext|>", "naïve café_snake", ""]


def test_tokenizer_equals_jax(tmp_path):
    """Synthetic merges, the merges-free CLIP layout and a gzip merges file
    in the published format: every id, vocabulary and decode as JAX's."""
    lines = ["#version: 0.2"] + [" ".join(m) for m in MERGES]
    path = tmp_path / "merges.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    for port, ref in ((SimpleTokenizer(MERGES), JaxTokenizer(MERGES)),
                      (SimpleTokenizer.default(), JaxTokenizer.default()),
                      (SimpleTokenizer(str(path)), JaxTokenizer(str(path)))):
        assert port.vocab_size == ref.vocab_size
        assert (port.sot, port.eot) == (ref.sot, ref.eot)
        np.testing.assert_array_equal(port.tokenize(TEXTS),
                                      ref.tokenize(TEXTS))
        for text in TEXTS:
            ids = port.encode(text)
            assert ids == ref.encode(text)
            assert port.decode(ids) == ref.decode(ids)
    long = "hello " * 100
    np.testing.assert_array_equal(
        SimpleTokenizer(MERGES).tokenize(long, truncate=True),
        JaxTokenizer(MERGES).tokenize(long, truncate=True))
    with pytest.raises(RuntimeError, match="too long"):
        SimpleTokenizer(MERGES).tokenize(long)
