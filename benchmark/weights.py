"""Random weights from the seed, in the program's params layout.

The benchmark makes the weights itself and hands the same tensors to the
program and, made again from the same seed after the window, to the
reference. They are drawn on the device by one ``torch.Generator`` in three
large calls (the talker's matmul weights, the other bf16 leaves, the f32
codebooks), each leaf a view of one buffer scaled in place, in the types the
model is served in. The talker's matmul weights have a buffer of their own,
so that a quantizing program frees it once it holds its own copies.

Scales follow the usual initialisation of such a model: embeddings and the
code predictor N(0, 0.02), a dense or convolution weight N(0, 1 / fan-in),
norms at one, codebooks N(0, 0.05).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

BF16 = torch.bfloat16


def _layout(cfg: Dict) -> Tuple[List, List]:
    """``(talker, rest)``: lists of ``(path, shape, scale)`` of the bf16 leaves."""
    t, c = cfg["talker"], cfg["codec"]
    h, L, f = t["hidden"], t["layers"], t["ffn"]
    hq, hkv, d = t["q_heads"], t["kv_heads"], t["head_dim"]
    nq, size, dim = c["n_codebooks"], c["codebook_size"], c["codebook_dim"]
    audio_vocab = size + 3
    cp = cfg["code_predictor_hidden"]
    talker = [
        (("talker", "blocks", "wqkv"), (L, h, (hq + 2 * hkv) * d), 1 / math.sqrt(h)),
        (("talker", "blocks", "wo"), (L, hq * d, h), 1 / math.sqrt(hq * d)),
        (("talker", "blocks", "w_gate"), (L, h, f), 1 / math.sqrt(h)),
        (("talker", "blocks", "w_up"), (L, h, f), 1 / math.sqrt(h)),
        (("talker", "blocks", "w_down"), (L, f, h), 1 / math.sqrt(f)),
    ]
    rest = [
        (("text_embed",), (cfg["text_vocab"], h), 0.02),
        (("audio_embed",), (nq, audio_vocab, h), 0.02),
        (("speaker_embed",), (cfg["n_speakers"], h), 0.02),
        (("lm_head",), (h, audio_vocab), 1 / math.sqrt(h)),
        (("code_predictor", "w1"), (nq - 1, 2 * h, cp), 0.02),
        (("code_predictor", "w2"), (nq - 1, cp, size), 0.02),
    ]

    def conv(path, cout, cin, k, transpose=False):
        shape = (cin, cout, k) if transpose else (cout, cin, k)
        rest.append((path, shape, 1 / math.sqrt(k * cin)))

    def resblock(path, ch):
        for i in range(len(c["resblock_dilations"])):
            conv(path + ("convs_d", i), ch, ch, 3)
            conv(path + ("convs_p", i), ch, ch, 1)

    enc, rates = c["encoder_channels"], list(reversed(c["upsample_rates"]))
    conv(("codec", "encoder", "conv_pre"), enc[0], 1, 7)
    for i, r in enumerate(rates):
        conv(("codec", "encoder", "downs", i), enc[i + 1], enc[i], 2 * r)
        resblock(("codec", "encoder", "resblocks", i), enc[i + 1])
    conv(("codec", "encoder", "conv_post"), dim, enc[-1], 3)
    dec = c["decoder_channels"]
    conv(("codec", "decoder", "conv_pre"), dec[0], dim, 7)
    for i, r in enumerate(c["upsample_rates"]):
        conv(("codec", "decoder", "ups", i), dec[i + 1], dec[i], 2 * r, transpose=True)
        resblock(("codec", "decoder", "resblocks", i), dec[i + 1])
    conv(("codec", "decoder", "conv_post"), 1, dec[len(c["upsample_rates"])], 7)
    return talker, rest


def _put(tree: Dict, path: Tuple, value) -> None:
    """Set ``tree[path]``; integer keys make lists, in order."""
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append([] if isinstance(nxt, int) else {})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    if isinstance(path[-1], int):
        node.append(value)
    else:
        node[path[-1]] = value


def _draw(gen: torch.Generator, leaves: List, device, tree: Dict) -> None:
    """One randn call for ``leaves``; each leaf a scaled view of the buffer."""
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    buf = torch.randn(total, generator=gen, dtype=BF16, device=device)
    at = 0
    for path, shape, scale in leaves:
        n = math.prod(shape)
        _put(tree, path, buf[at: at + n].view(shape).mul_(scale))
        at += n


def make_params(cfg: Dict, seed: int, device) -> Dict:
    """The whole params tree of one configuration from ``seed`` on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    t, c = cfg["talker"], cfg["codec"]
    tree: Dict = {}
    talker, rest = _layout(cfg)
    _draw(gen, talker, device, tree)
    _draw(gen, rest, device, tree)
    ones = dict(dtype=torch.float32, device=device)
    tree["talker"]["blocks"]["attn_norm"] = torch.ones((t["layers"], t["hidden"]), **ones)
    tree["talker"]["blocks"]["mlp_norm"] = torch.ones((t["layers"], t["hidden"]), **ones)
    tree["talker"]["final_norm"] = torch.ones((t["hidden"],), **ones)
    books = torch.randn((c["n_codebooks"], c["codebook_size"], c["codebook_dim"]),
                        generator=gen, dtype=torch.float32, device=device)
    tree["codec"]["rvq"] = {"codebooks": books.mul_(0.05)}
    return tree
