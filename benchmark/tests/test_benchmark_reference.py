"""The plain references against themselves: float32 against float64 at a
tiny size, causality, and the control's rounding."""

import torch

from benchmark import weights as W
from benchmark.reference.encodec import EncodecDecoderReference
from benchmark.reference.stage import StageReference, quantize_columns
from benchmark.reference.text import TextReference, bpe_ids, tf32
from benchmark.demo_vocab import write_demo_vocab

SPECS = [(16, 2), (16, 1), (16, 3)]


def stage_weights(dim=32, depth=2, heads=2, dh=8, inner=20):
    shapes = [(f"embeds.{i}.weight", ((cb + 1) * q, dim)) for i, (cb, q) in enumerate(SPECS)]
    shapes += [(f"logit_heads.{i}", (q, cb + 1, dim)) for i, (cb, q) in enumerate(SPECS)]
    shapes += [("start_tokens", (len(SPECS), dim))]
    p = "transformer.rel_pos_bias."
    shapes += [(p + "in_layer.weight", (dim // 2, 1)), (p + "in_layer.bias", (dim // 2,))]
    shapes += [(p + f"mid_layers.{k}.weight", (dim // 2, dim // 2)) for k in range(2)]
    shapes += [(p + f"mid_layers.{k}.bias", (dim // 2,)) for k in range(2)]
    shapes += [(p + "out_layer.weight", (heads, dim // 2)), (p + "out_layer.bias", (heads,))]
    for l in range(depth):
        a, f = f"transformer.attns.{l}.", f"transformer.ffs.{l}."
        shapes += [(a + "norm.gamma", (dim,)), (a + "to_q.weight", (heads * dh, dim)), (a + "to_kv.weight", (2 * dh, dim)),
                   (a + "q_scale", (dh,)), (a + "k_scale", (dh,)), (a + "to_out.weight", (dim, heads * dh)),
                   (f + "norm_in.gamma", (dim,)), (f + "proj_in.weight", (2 * inner, dim)), (f + "conv_w", (3, 2 * inner)),
                   (f + "norm_mid.gamma", (inner,)), (f + "proj_out.weight", (dim, inner))]
    shapes += [("transformer.final_norm.gamma", (dim,))]
    return W.draw(shapes, 5, "test", "cpu", torch.float32)


def test_stage_float32_against_float64():
    w = stage_weights()
    g = torch.Generator().manual_seed(0)
    cond = [torch.randint(0, 16, (2, 4), generator=g), torch.randint(0, 16, (2, 5), generator=g)]
    tokens = torch.randint(0, 16, (2, 9), generator=g)
    a = StageReference(w, SPECS, 2, 2, 8).logits(cond, tokens, 3)
    out = StageReference(w, SPECS, 2, 2, 8, dtype=torch.float64).logits(cond, tokens, 3)
    assert a.shape == (2, 6, 17)
    assert torch.allclose(a.double(), out, atol=1e-4 * out.abs().max().item())


def test_stage_is_causal():
    w = stage_weights()
    ref = StageReference(w, SPECS, 2, 2, 8)
    g = torch.Generator().manual_seed(1)
    cond = [torch.randint(0, 16, (1, 4), generator=g), torch.randint(0, 16, (1, 5), generator=g)]
    tokens = torch.randint(0, 16, (1, 9), generator=g)
    later = tokens.clone()
    later[0, 6:] = (later[0, 6:] + 1) % 16
    a, b = ref.logits(cond, tokens, 0), ref.logits(cond, later, 0)
    assert torch.equal(a[:, :7], b[:, :7])  # logits up to token 6 see tokens before it only
    assert not torch.equal(a[:, 7:], b[:, 7:])


def test_int4_and_fp8_controls_round():
    w = torch.randn(6, 10)
    q = quantize_columns(w, 4)
    assert all(len(set(torch.round(r / (r.abs().max() / 7)).tolist())) <= 15 for r in q)
    x = torch.randn(100)
    t = tf32(x)
    assert torch.all((t - x).abs() <= x.abs() * 2 ** -11 + 1e-30) and not torch.equal(t, x)


def test_encodec_float32_against_float64():
    shapes = [("codebooks", (8, 16, 128))]
    shapes += [("decoder.conv_in.conv.weight", (512, 128, 7)), ("decoder.conv_in.conv.bias", (512,))]
    for kind in ("ih", "hh"):
        for l in range(2):
            shapes += [(f"decoder.lstm.lstm.weight_{kind}_l{l}", (2048, 512)), (f"decoder.lstm.lstm.bias_{kind}_l{l}", (2048,))]
    ch = 512
    for i, r in enumerate((8, 5, 4, 2)):
        shapes += [(f"decoder.ups.{i}.convtr.weight", (ch, ch // 2, 2 * r)), (f"decoder.ups.{i}.convtr.bias", (ch // 2,))]
        ch //= 2
        shapes += [(f"decoder.res.{i}.block_conv1.conv.weight", (ch // 2, ch, 3)), (f"decoder.res.{i}.block_conv1.conv.bias", (ch // 2,)),
                   (f"decoder.res.{i}.block_conv2.conv.weight", (ch, ch // 2, 1)), (f"decoder.res.{i}.block_conv2.conv.bias", (ch,)),
                   (f"decoder.res.{i}.shortcut.conv.weight", (ch, ch, 1)), (f"decoder.res.{i}.shortcut.conv.bias", (ch,))]
    shapes += [("decoder.conv_out.conv.weight", (1, 32, 7)), ("decoder.conv_out.conv.bias", (1,))]
    w = W.draw(shapes, 3, "codec", "cpu", torch.float32)
    codes = torch.randint(0, 16, (1, 3, 8), generator=torch.Generator().manual_seed(2))
    a = EncodecDecoderReference(w).decode(codes)
    assert a.shape == (1, 3 * 320)
    b = EncodecDecoderReference(w, dtype=torch.float64).decode(codes)
    assert torch.allclose(a.double(), b.double(), atol=1e-5 * b.abs().max().item())


def test_text_bpe_and_tower(tmp_path):
    vocab, merges = write_demo_vocab(tmp_path)
    ids, mask = bpe_ids("the warm bass", vocab, merges)
    assert len(ids) == len(mask) == 77 and ids[0] == 0 and sum(mask) == ids.index(2) + 1
    assert vocab["Ġb"] in ids and vocab["Ġt"] not in ids  # "the" first, no leading space
    try:
        from open_musiclm_torch.models.clap.tokenizer import RobertaTokenizer
    except ImportError:
        return
    prog = RobertaTokenizer.from_dir(str(tmp_path))(["the warm bass", "a calm ambient piano drone"])
    ours = [bpe_ids(t, vocab, merges) for t in ("the warm bass", "a calm ambient piano drone")]
    assert prog["input_ids"].tolist() == [i for i, _ in ours]
    assert prog["attention_mask"].tolist() == [m for _, m in ours]


def test_fp8_control_rounds_every_product_of_bf16_training(monkeypatch):
    """The fp8 control rounds both operands of the projections, the logit
    heads, the relative-position MLP and attention's two products."""
    from benchmark.reference import stage as S

    w = stage_weights()
    calls = []
    real = S.fp8
    monkeypatch.setattr(S, "fp8", lambda x: calls.append(tuple(x.shape)) or real(x))
    g = torch.Generator().manual_seed(4)
    cond = [torch.randint(0, 16, (1, 4), generator=g), torch.randint(0, 16, (1, 5), generator=g)]
    tokens = torch.randint(0, 16, (1, 6), generator=g)
    out = S.StageReference(w, SPECS, 2, 2, 8, precision="fp8").logits(cond, tokens, 0)
    # per layer: to_q, to_kv, scores, weighted sum, to_out, proj_in, proj_out; the MLP's
    # four layers; one logit head for each of the final sequence's three quantizers
    assert len(calls) == 2 * (2 * 7 + 4 + 3)
    n = (1 + 4 + 1) + (1 + 5 + 1) + (1 + 5)  # each sequence's start and EOS, the last's shifted
    assert (1, 2, n, n) in calls and (2 * n - 1, 1) in calls
    ref = S.StageReference(w, SPECS, 2, 2, 8).logits(cond, tokens, 0)
    assert not torch.allclose(out, ref, atol=1e-3 * ref.abs().max().item())
