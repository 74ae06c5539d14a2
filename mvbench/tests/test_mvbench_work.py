"""The work of the three serving cells' unit, as the t2v and i2v families
count it (``work(config, mix)``), is what ``reference.counting.work`` gave
before the families counted it: the model FLOPs and every attention and
feed-forward call by shape, at the shipped configurations, refined and
plain, on the meta device. The per-layer readers ``model.mfu_pct.serve``
and the two ``kernels.*_roofline_pct.serve`` divide by these counts."""

import collections
import importlib
import json
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# {(family, refine): (FLOPs, {call: times})}; a call is ("attn", B, S_q, S_kv,
# H, D, masked) or ("ffn", T, C, inner)
PARENT = {
    ("t2v", True): (759010413539328.0, {
        ("attn", 1, 1024, 1024, 16, 64, False): 15,
        ("attn", 1, 256, 256, 16, 64, False): 18,
        ("attn", 1, 4096, 4096, 16, 32, False): 15,
        ("attn", 1, 77, 77, 16, 64, True): 23,
        ("attn", 1024, 24, 24, 5, 64, False): 30,
        ("attn", 1024, 24, 24, 8, 64, False): 6,
        ("attn", 128, 24, 24, 20, 64, False): 470,
        ("attn", 16, 24, 24, 20, 64, False): 6,
        ("attn", 2048, 24, 24, 5, 64, False): 470,
        ("attn", 2048, 24, 24, 8, 64, False): 94,
        ("attn", 24, 1024, 1024, 1, 512, False): 4,
        ("attn", 24, 1024, 1024, 5, 64, False): 15,
        ("attn", 24, 1024, 77, 5, 64, False): 15,
        ("attn", 24, 16, 16, 20, 64, False): 3,
        ("attn", 24, 16, 77, 20, 64, False): 3,
        ("attn", 24, 256, 256, 10, 64, False): 15,
        ("attn", 24, 256, 77, 10, 64, False): 15,
        ("attn", 24, 64, 64, 20, 64, False): 15,
        ("attn", 24, 64, 77, 20, 64, False): 15,
        ("attn", 256, 24, 24, 10, 64, False): 30,
        ("attn", 32, 24, 24, 20, 64, False): 94,
        ("attn", 4, 1024, 1024, 1, 512, False): 3,
        ("attn", 48, 1024, 1024, 5, 64, False): 235,
        ("attn", 48, 1024, 77, 5, 64, False): 235,
        ("attn", 48, 16, 16, 20, 64, False): 47,
        ("attn", 48, 16, 77, 20, 64, False): 47,
        ("attn", 48, 256, 256, 10, 64, False): 235,
        ("attn", 48, 256, 77, 10, 64, False): 235,
        ("attn", 48, 64, 64, 20, 64, False): 235,
        ("attn", 48, 64, 77, 20, 64, False): 235,
        ("attn", 512, 24, 24, 10, 64, False): 470,
        ("attn", 64, 24, 24, 20, 64, False): 30,
        ("ffn", 12288, 640, 2560): 470,
        ("ffn", 1536, 1280, 5120): 30,
        ("ffn", 24576, 320, 1280): 30,
        ("ffn", 24576, 512, 2048): 3,
        ("ffn", 3072, 1280, 5120): 470,
        ("ffn", 384, 1280, 5120): 6,
        ("ffn", 49152, 320, 1280): 470,
        ("ffn", 49152, 512, 2048): 47,
        ("ffn", 6144, 640, 2560): 30,
        ("ffn", 768, 1280, 5120): 94,
    }),
    ("t2v", False): (748575229538304.0, {
        ("attn", 1, 77, 77, 16, 64, True): 23,
        ("attn", 128, 24, 24, 20, 64, False): 500,
        ("attn", 2048, 24, 24, 5, 64, False): 500,
        ("attn", 2048, 24, 24, 8, 64, False): 100,
        ("attn", 24, 1024, 1024, 1, 512, False): 1,
        ("attn", 32, 24, 24, 20, 64, False): 100,
        ("attn", 48, 1024, 1024, 5, 64, False): 250,
        ("attn", 48, 1024, 77, 5, 64, False): 250,
        ("attn", 48, 16, 16, 20, 64, False): 50,
        ("attn", 48, 16, 77, 20, 64, False): 50,
        ("attn", 48, 256, 256, 10, 64, False): 250,
        ("attn", 48, 256, 77, 10, 64, False): 250,
        ("attn", 48, 64, 64, 20, 64, False): 250,
        ("attn", 48, 64, 77, 20, 64, False): 250,
        ("attn", 512, 24, 24, 10, 64, False): 500,
        ("ffn", 12288, 640, 2560): 500,
        ("ffn", 3072, 1280, 5120): 500,
        ("ffn", 49152, 320, 1280): 500,
        ("ffn", 49152, 512, 2048): 50,
        ("ffn", 768, 1280, 5120): 100,
    }),
    ("i2v", True): (769623037014016.0, {
        ("attn", 1, 1024, 1024, 1, 512, False): 1,
        ("attn", 1, 1024, 1024, 16, 64, False): 15,
        ("attn", 1, 256, 256, 16, 64, False): 18,
        ("attn", 1, 257, 257, 16, 80, False): 32,
        ("attn", 1, 4096, 4096, 16, 32, False): 15,
        ("attn", 1, 77, 77, 16, 64, True): 23,
        ("attn", 1024, 24, 24, 2, 4, False): 3,
        ("attn", 1024, 24, 24, 5, 64, False): 30,
        ("attn", 1024, 24, 24, 8, 64, False): 6,
        ("attn", 128, 24, 24, 20, 64, False): 470,
        ("attn", 16, 24, 24, 20, 64, False): 6,
        ("attn", 2048, 24, 24, 2, 4, False): 47,
        ("attn", 2048, 24, 24, 5, 64, False): 470,
        ("attn", 2048, 24, 24, 8, 64, False): 94,
        ("attn", 24, 1024, 1024, 1, 512, False): 4,
        ("attn", 24, 1024, 1024, 5, 64, False): 15,
        ("attn", 24, 1024, 145, 5, 64, False): 15,
        ("attn", 24, 16, 145, 20, 64, False): 3,
        ("attn", 24, 16, 16, 20, 64, False): 3,
        ("attn", 24, 256, 145, 10, 64, False): 15,
        ("attn", 24, 256, 256, 10, 64, False): 15,
        ("attn", 24, 64, 145, 20, 64, False): 15,
        ("attn", 24, 64, 64, 20, 64, False): 15,
        ("attn", 256, 24, 24, 10, 64, False): 30,
        ("attn", 32, 24, 24, 20, 64, False): 94,
        ("attn", 4, 1024, 1024, 1, 512, False): 3,
        ("attn", 48, 1024, 1024, 5, 64, False): 235,
        ("attn", 48, 1024, 145, 5, 64, False): 235,
        ("attn", 48, 16, 145, 20, 64, False): 47,
        ("attn", 48, 16, 16, 20, 64, False): 47,
        ("attn", 48, 256, 145, 10, 64, False): 235,
        ("attn", 48, 256, 256, 10, 64, False): 235,
        ("attn", 48, 64, 145, 20, 64, False): 235,
        ("attn", 48, 64, 64, 20, 64, False): 235,
        ("attn", 512, 24, 24, 10, 64, False): 470,
        ("attn", 64, 24, 24, 20, 64, False): 30,
        ("ffn", 12288, 640, 2560): 470,
        ("ffn", 1536, 1280, 5120): 30,
        ("ffn", 24576, 320, 1280): 30,
        ("ffn", 24576, 512, 2048): 3,
        ("ffn", 3072, 1280, 5120): 470,
        ("ffn", 384, 1280, 5120): 6,
        ("ffn", 49152, 320, 1280): 470,
        ("ffn", 49152, 512, 2048): 47,
        ("ffn", 6144, 640, 2560): 30,
        ("ffn", 768, 1280, 5120): 94,
    }),
    ("i2v", False): (759497295622144.0, {
        ("attn", 1, 1024, 1024, 1, 512, False): 1,
        ("attn", 1, 257, 257, 16, 80, False): 32,
        ("attn", 1, 77, 77, 16, 64, True): 23,
        ("attn", 128, 24, 24, 20, 64, False): 500,
        ("attn", 2048, 24, 24, 2, 4, False): 50,
        ("attn", 2048, 24, 24, 5, 64, False): 500,
        ("attn", 2048, 24, 24, 8, 64, False): 100,
        ("attn", 24, 1024, 1024, 1, 512, False): 1,
        ("attn", 32, 24, 24, 20, 64, False): 100,
        ("attn", 48, 1024, 1024, 5, 64, False): 250,
        ("attn", 48, 1024, 145, 5, 64, False): 250,
        ("attn", 48, 16, 145, 20, 64, False): 50,
        ("attn", 48, 16, 16, 20, 64, False): 50,
        ("attn", 48, 256, 145, 10, 64, False): 250,
        ("attn", 48, 256, 256, 10, 64, False): 250,
        ("attn", 48, 64, 145, 20, 64, False): 250,
        ("attn", 48, 64, 64, 20, 64, False): 250,
        ("attn", 512, 24, 24, 10, 64, False): 500,
        ("ffn", 12288, 640, 2560): 500,
        ("ffn", 3072, 1280, 5120): 500,
        ("ffn", 49152, 320, 1280): 500,
        ("ffn", 49152, 512, 2048): 50,
        ("ffn", 768, 1280, 5120): 100,
    }),
}


@pytest.mark.parametrize("family,refine", sorted(PARENT))
def test_the_family_counts_the_work_the_parent_counted(family, refine):
    with open(os.path.join(BENCH, "configs", family + ".json")) as f:
        config = json.load(f)
    work = importlib.import_module(f"mvbench.families.{family}").work(config, {"refine": refine})
    flops, calls = PARENT[(family, refine)]
    assert work["flops"] == flops
    assert collections.Counter((c[0],) + tuple(c[1]) + tuple(c[2:]) for c in work["calls"]) == \
        calls
