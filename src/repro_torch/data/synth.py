"""Synthetic analogues of the paper's five datasets (Table 2).

The paper's corpora (Amazon Book Reviews/Titles, ABC News Headlines, Tweets,
OpenWebText URLs) are not available offline, so we generate seeded synthetic
corpora engineered to match their *structural* statistics — average string
length, token redundancy profile, shared-prefix skew (URLs), and vocabulary
shape — the properties the algorithms actually interact with. All generators
are deterministic in (seed, size).

| name           | analogue       | avg len | character                        |
|----------------|----------------|---------|----------------------------------|
| book_titles    | Book Titles    |  ~52 B  | Zipfian word mix, catalog noise  |
| book_reviews   | Book Reviews   | ~420 B  | long natural-ish sentences       |
| news_headlines | News Headlines |  ~41 B  | short Zipfian word strings       |
| tweets         | Tweets         |  ~74 B  | words + handles + hashtags + urls|
| urls           | URLs           |  ~84 B  | few domains, deep shared prefixes|
"""

from __future__ import annotations

import numpy as np

_CONSONANTS = np.frombuffer(b"bcdfghjklmnpqrstvwz", dtype=np.uint8)
_VOWELS = np.frombuffer(b"aeiou", dtype=np.uint8)


def _word_vocab(rng: np.random.Generator, n: int, min_syl=1, max_syl=4) -> list[bytes]:
    """Pronounceable pseudo-words: CV(C) syllables — realistic byte bigrams."""
    words = []
    for _ in range(n):
        syl = rng.integers(min_syl, max_syl + 1)
        w = bytearray()
        for _ in range(syl):
            w.append(int(rng.choice(_CONSONANTS)))
            w.append(int(rng.choice(_VOWELS)))
            if rng.random() < 0.3:
                w.append(int(rng.choice(_CONSONANTS)))
        words.append(bytes(w))
    return words


def _zipf_indices(rng: np.random.Generator, n_vocab: int, size: int, a: float = 1.15) -> np.ndarray:
    """Zipf-distributed indices clipped into [0, n_vocab)."""
    idx = rng.zipf(a, size=size) - 1
    return np.minimum(idx, n_vocab - 1)


def gen_book_titles(target_bytes: int, seed: int = 0) -> list[bytes]:
    rng = np.random.default_rng(seed)
    vocab = _word_vocab(rng, 4000, 1, 4)
    series = [b"The " + w.capitalize() for w in _word_vocab(rng, 50, 2, 3)]
    out: list[bytes] = []
    total = 0
    while total < target_bytes:
        nw = int(rng.integers(3, 10))
        words = [vocab[i] for i in _zipf_indices(rng, len(vocab), nw)]
        title = b" ".join(w.capitalize() if rng.random() < 0.7 else w for w in words)
        r = rng.random()
        if r < 0.15:
            title = series[int(rng.integers(len(series)))] + b": " + title
        elif r < 0.25:
            title += b" (Vol. %d)" % int(rng.integers(1, 30))
        elif r < 0.32:
            title += b" - Special Edition"
        out.append(title)
        total += len(title)
    return out


def gen_book_reviews(target_bytes: int, seed: int = 1) -> list[bytes]:
    rng = np.random.default_rng(seed)
    vocab = _word_vocab(rng, 8000, 1, 4)
    stock = [b"I really enjoyed this book", b"would recommend to anyone",
             b"the author writes", b"could not put it down",
             b"a bit slow in the middle", b"five stars", b"not worth the price",
             b"the characters are", b"great read for the summer"]
    out: list[bytes] = []
    total = 0
    while total < target_bytes:
        sentences = []
        for _ in range(int(rng.integers(3, 9))):
            if rng.random() < 0.35:
                sentences.append(stock[int(rng.integers(len(stock)))])
            nw = int(rng.integers(5, 15))
            words = [vocab[i] for i in _zipf_indices(rng, len(vocab), nw)]
            sentences.append(b" ".join(words) + b".")
        review = b" ".join(sentences)
        out.append(review)
        total += len(review)
    return out


def gen_news_headlines(target_bytes: int, seed: int = 2) -> list[bytes]:
    rng = np.random.default_rng(seed)
    vocab = _word_vocab(rng, 3000, 1, 3)
    out: list[bytes] = []
    total = 0
    while total < target_bytes:
        nw = int(rng.integers(4, 9))
        words = [vocab[i] for i in _zipf_indices(rng, len(vocab), nw)]
        h = b" ".join(words)
        out.append(h)
        total += len(h)
    return out


def gen_tweets(target_bytes: int, seed: int = 3) -> list[bytes]:
    rng = np.random.default_rng(seed)
    vocab = _word_vocab(rng, 5000, 1, 3)
    handles = [b"@" + w for w in _word_vocab(rng, 300, 2, 3)]
    tags = [b"#" + w for w in _word_vocab(rng, 200, 1, 3)]
    out: list[bytes] = []
    total = 0
    while total < target_bytes:
        parts: list[bytes] = []
        if rng.random() < 0.3:
            parts.append(handles[int(rng.integers(len(handles)))])
        nw = int(rng.integers(7, 19))
        parts += [vocab[i] for i in _zipf_indices(rng, len(vocab), nw)]
        if rng.random() < 0.4:
            parts.append(tags[int(rng.integers(len(tags)))])
        if rng.random() < 0.15:
            parts.append(b"http://t.co/%08x" % int(rng.integers(1 << 31)))
        t = b" ".join(parts)
        out.append(t)
        total += len(t)
    return out


def gen_urls(target_bytes: int, seed: int = 4) -> list[bytes]:
    """Heavy shared-prefix skew: few domains, deep paths, id-suffix variants —
    the adversarial case for unbounded LPM buckets (paper §3.4.4, §4.7)."""
    rng = np.random.default_rng(seed)
    domains = [b"https://www." + w + bytes(tld) for w, tld in
               zip(_word_vocab(rng, 120, 2, 4),
                   rng.choice([b".com", b".org", b".net", b".io"], 120))]
    segs = _word_vocab(rng, 600, 2, 4)
    out: list[bytes] = []
    total = 0
    while total < target_bytes:
        d = domains[int(_zipf_indices(rng, len(domains), 1)[0])]
        depth = int(rng.integers(2, 7))
        path = b"/".join(segs[i] for i in _zipf_indices(rng, len(segs), depth))
        url = d + b"/" + path
        r = rng.random()
        if r < 0.35:
            url += b"/item_id_%06d" % int(rng.integers(1000000))
        elif r < 0.5:
            url += b"?page=%d&ref=%s" % (int(rng.integers(50)),
                                         segs[int(rng.integers(len(segs)))])
        out.append(url)
        total += len(url)
    return out


DATASETS = {
    "book_titles": gen_book_titles,
    "book_reviews": gen_book_reviews,
    "news_headlines": gen_news_headlines,
    "tweets": gen_tweets,
    "urls": gen_urls,
}


def load_dataset(name: str, target_bytes: int = 8 << 20, seed: int | None = None) -> list[bytes]:
    gen = DATASETS[name]
    if seed is None:
        return gen(target_bytes)
    return gen(target_bytes, seed=seed)



def dataset_stats(strings: list[bytes]) -> dict:
    lens = np.array([len(s) for s in strings])
    return {"rows": len(strings), "bytes": int(lens.sum()),
            "avg_len": float(lens.mean()), "mib": float(lens.sum() / (1 << 20))}
