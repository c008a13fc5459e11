"""The general text generator: the same seed gives the same traffic, every
seed the same multiset of lengths, and the lengths are what the mix states."""

import numpy as np
import pytest

from benchmark.harness import texts
from benchmark.harness.spec import load_cell
from benchmark.harness.weights import sub_seed
from benchmark.reference.tokenizer import Tokenizer

QUERIES = load_cell("search-e5s-msmarco8m-exact").traffic["query_tokens"]
PASSAGES = load_cell("encode-e5s-msmarco-passages").traffic["passage_tokens"]
BIG_SEED = 2**33 + 12345


def draw(dist, n, seed):
    rng = np.random.default_rng(sub_seed(seed, 3))
    lens = texts.lengths(dist, n, rng)
    return lens, texts.texts(lens, rng)


@pytest.mark.parametrize("dist", [QUERIES, PASSAGES], ids=["queries", "passages"])
def test_same_seed_same_traffic(dist):
    (la, ta), (lb, tb) = draw(dist, 500, BIG_SEED), draw(dist, 500, BIG_SEED)
    assert la.tolist() == lb.tolist() and ta == tb


@pytest.mark.parametrize("dist", [QUERIES, PASSAGES], ids=["queries", "passages"])
def test_seeds_share_the_lengths_in_another_order(dist):
    a, ta = draw(dist, 2000, 1)
    b, tb = draw(dist, 2000, BIG_SEED)
    assert sorted(a.tolist()) == sorted(b.tolist())
    assert a.tolist() != b.tolist() and ta != tb


@pytest.mark.parametrize("dist,mean", [(QUERIES, 8.0), (PASSAGES, 80.0)],
                         ids=["queries", "passages"])
def test_stated_lengths(dist, mean):
    lens = texts.quantile_lengths(dist, 20000)
    assert lens.min() >= dist["min"] and lens.max() <= dist["max"]
    assert abs(lens.mean() - mean) / mean < 0.03


def test_each_word_is_one_token():
    tok = Tokenizer()
    lens, drawn = draw(PASSAGES, 200, 7)
    assert [len(tok.tokenize(t)) for t in drawn] == lens.tolist()


def test_the_vocabulary_is_the_programs():
    from sskd_tpu_torch.tokenization import get_default_tokenizer

    assert Tokenizer().vocab == get_default_tokenizer().vocab


def test_sub_seeds_take_large_seeds():
    seeds = {sub_seed(s, 1) for s in (0, 1, 2**31 - 1, 2**31 + 5, 2**40)}
    assert len(seeds) == 5 and all(0 <= s < 2**63 for s in seeds)
