"""The benchmark's inputs, made from ``--seed``: the target database and the
request pool of a traffic mix.

``make_proteins``, ``_member`` and ``make_reads`` are frozen copies of the
port's smoke-run generators (``chip_smoke.make_proteins`` / ``_member`` /
``make_reads``), reading the BLOSUM62 background frequencies from
``data/blosum62.json`` instead of the program.  ``make_proteins`` also takes
a ``size_seed``: the set's lengths, families, identities and indels come
from it, only the letters from ``seed``.  ``make_db`` makes a
configuration's database from its ``db`` block, and ``make_pool`` is the
one general traffic generator: it reads a traffic mix's parameters
(``traffic/<name>.json``) and nothing else.
"""
from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
AA = "ARNDCQEGHILKMFPSTWYV"  # order of the BLOSUM62 background frequencies
STANDARD_CODE = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
BASES = "TCAG"  # the code's codon order: TCAG x TCAG x TCAG


def background() -> np.ndarray:
    with open(os.path.join(HERE, "data", "blosum62.json")) as f:
        bg = np.asarray(json.load(f)["background_freqs"], np.float64)
    return bg / bg.sum()


def make_proteins(n_seqs: int = 10_000, n_families: int = 2_500,
                  seed: int = 0, size_seed: int | None = None):
    """Seeded synthetic protein set with planted homologs: family roots of
    log-normal length (median ~300, clipped to 30-3000) drawn from the
    BLOSUM62 background frequencies; every other sequence is a member of a
    random family at 40-95 % identity with a few short indels.  Returns
    [(id, sequence)] in shuffled order.  With ``size_seed`` the lengths,
    families, identities, indels and order come from it and only the
    letters from ``seed``; without it (the smoke run's generator) all
    from ``seed``."""
    rng = np.random.default_rng(seed)
    srng = rng if size_seed is None else np.random.default_rng(size_seed)
    bg = background()
    letters = np.frombuffer(AA.encode(), np.uint8)

    def draw(n):
        return letters[rng.choice(20, size=n, p=bg)]

    lens = np.clip(np.rint(srng.lognormal(np.log(300), 0.7, n_families)),
                   30, 3000).astype(int)
    roots = [draw(n) for n in lens]
    seqs = []
    for k in range(n_seqs):
        fam = k if k < n_families else int(srng.integers(n_families))
        s = roots[fam]
        if k >= n_families:
            s = _member(rng, s, srng.uniform(0.40, 0.95), draw, srng)
        seqs.append((f"syn{k:05d}_fam{fam:04d}", s.tobytes().decode()))
    perm = srng.permutation(n_seqs)
    return [seqs[i] for i in perm]


def _member(rng, root, ident, draw, srng=None):
    """A family member: the root at identity ``ident`` with a few short
    indels (their number, places and lengths drawn from ``srng``, the
    letters and substituted places from ``rng``)."""
    srng = rng if srng is None else srng
    s = root.copy()
    sub = rng.random(len(s)) > ident
    s[sub] = draw(int(sub.sum()))
    for _ in range(int(srng.poisson(2))):
        pos = int(srng.integers(len(s)))
        ln = int(srng.integers(1, 6))
        if srng.random() < 0.5:
            s = np.concatenate([s[:pos], draw(ln), s[pos:]])
        elif len(s) - ln >= 30:
            s = np.concatenate([s[:pos], s[pos + ln:]])
    return s


def write_fasta(path, recs):
    with open(path, "w") as f:
        for name, s in recs:
            f.write(f">{name}\n{s}\n")


def family_of(name: str) -> int:
    """The planted family of a database or query id (``..._famNNNN``)."""
    return int(name.rsplit("_fam", 1)[1])


def split_seed(seed: int, n: int = 4) -> list[int]:
    """Independent streams of one ``--seed`` of any size."""
    ss = np.random.SeedSequence(abs(int(seed)))
    return [int(s.generate_state(1, np.uint64)[0]) for s in ss.spawn(n)]


def query_sizes(traffic: dict) -> tuple[np.ndarray, np.ndarray]:
    """Lengths and related flags of every pool query, [pool_requests + 1,
    queries_per_request] (the last row is the warm request).  Drawn from
    the traffic file's own ``size_seed``, so every ``--seed`` sends the same
    sizes and the same mix, only other letters."""
    rng = np.random.default_rng(int(traffic["size_seed"]))
    shape = (int(traffic["pool_requests"]) + 1,
             int(traffic["queries_per_request"]))
    mu, sigma = traffic["length_lognormal"]
    lo, hi = traffic["length_clip"]
    lens = np.clip(np.rint(rng.lognormal(np.log(mu), sigma, shape)),
                   lo, hi).astype(int)
    related = rng.random(shape) < float(traffic["related_share"])
    return lens, related


def make_db(spec: dict, seed: int):
    """A configuration's target database from its ``db`` block:
    ``sequences`` proteins in ``families``, every size fixed by its
    ``size_seed``, so that ``--seed`` changes only the letters."""
    return make_proteins(int(spec["sequences"]), int(spec["families"]), seed,
                         size_seed=int(spec["size_seed"]))


def make_reads(proteins, n_reads: int, min_len: int, max_len: int,
               indels_per_kb: float = 0.0, subst: float = 0.01,
               seed: int = 0):
    """Seeded synthetic DNA reads from a protein set: each read back-
    translates a random member (or a window of it, when the member is
    longer than the read) with seeded codons of the standard code, adds
    random flanks up to a length drawn from [min_len, max_len], applies
    ~``subst`` substitutions and ``indels_per_kb`` single-nucleotide
    insertions or deletions per kb, and every other read is reverse
    complemented.  Returns [(name, dna)]; a read's name ends with the id of
    its source protein."""
    rng = np.random.default_rng(seed)
    codons: dict[str, list[str]] = {}
    for k, aa in enumerate(STANDARD_CODE):
        codons.setdefault(aa, []).append(
            BASES[k // 16] + BASES[k // 4 % 4] + BASES[k % 4])
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for r in range(n_reads):
        pid, prot = proteins[int(rng.integers(len(proteins)))]
        L = int(rng.integers(min_len, max_len + 1))
        n_aa = min(len(prot), (L - 30) // 3)
        a = int(rng.integers(len(prot) - n_aa + 1))
        cds = "".join(codons[c][int(rng.integers(len(codons[c])))]
                      for c in prot[a:a + n_aa])
        left = int(rng.integers(L - len(cds) + 1))
        dna = list("".join(BASES[x] for x in rng.integers(0, 4, left)) + cds
                   + "".join(BASES[x] for x in
                             rng.integers(0, 4, L - len(cds) - left)))
        for p in np.flatnonzero(rng.random(len(dna)) < subst):
            dna[p] = BASES[int(rng.integers(4))]
        for _ in range(int(rng.poisson(indels_per_kb * len(dna) / 1000))):
            p = int(rng.integers(len(dna)))
            if rng.random() < 0.5:
                dna.insert(p, BASES[int(rng.integers(4))])
            else:
                del dna[p]
        dna = "".join(dna)
        if r % 2:
            dna = dna.translate(comp)[::-1]
        reads.append((f"read{r:05d}_{pid}", dna))
    return reads


def make_pool(db, traffic: dict, seed: int):
    """The request pool: a list of requests, each a list of (id, sequence,
    family or -1).  A related query is a member of a database family whose
    root reaches its length (identity drawn from ``identity``, a few short
    indels, as the database's members), cut to that length; an unrelated
    one is drawn from the background.  Every size, family, identity, indel
    and cut comes from the traffic file's ``size_seed``, the letters from
    ``seed``.  With ``"queries": "reads"`` each such protein is
    back-translated into one DNA read (``make_reads``) whose length is
    drawn from ``read_length`` (nucleotides) with the same size seed; its
    ``indels_per_kb`` and ``subst`` go to ``make_reads``.  The last request
    of the list is the warm one."""
    rng = np.random.default_rng(seed)
    bg = background()
    letters = np.frombuffer(AA.encode(), np.uint8)

    def draw(n):
        return letters[rng.choice(20, size=n, p=bg)]

    roots = {}
    for name, s in db:
        fam = family_of(name)
        if name.startswith(f"syn{fam:05d}_"):  # the family's root
            roots[fam] = np.frombuffer(s.encode(), np.uint8)
    fams = np.array(sorted(roots))
    root_len = np.array([len(roots[f]) for f in fams])
    by_len = np.argsort(root_len, kind="stable")
    lo_id, hi_id = traffic["identity"]
    lens, related = query_sizes(traffic)
    srng = np.random.default_rng([int(traffic["size_seed"]), 1])
    kind = traffic.get("queries", "proteins")
    if kind not in ("proteins", "reads"):
        raise ValueError(f"no query kind {kind!r}")
    if kind == "reads":
        read_lo, read_hi = traffic["read_length"]
        read_lens = srng.integers(read_lo, read_hi + 1, lens.shape)
    pool = []
    for r in range(lens.shape[0]):
        req = []
        for k in range(lens.shape[1]):
            L = int(lens[r, k])
            name = f"q{r:04d}_{k:04d}"
            if related[r, k]:
                first = int(np.searchsorted(root_len[by_len], L))
                cand = by_len[first:] if first < len(by_len) else by_len[-1:]
                fam = int(fams[cand[int(srng.integers(len(cand)))]])
                s = _member(rng, roots[fam], srng.uniform(lo_id, hi_id), draw,
                            srng)
                off = int(srng.integers(max(len(s) - L, 0) + 1))
                s = s[off:off + L]
                name += f"_fam{fam:04d}"
            else:
                s, fam = draw(L), -1
                name += "_none"
            s = s.tobytes().decode()
            if kind == "reads":
                rl = int(read_lens[r, k])
                (name, s), = make_reads(
                    [(name, s)], 1, rl, rl,
                    float(traffic.get("indels_per_kb", 0.0)),
                    float(traffic.get("subst", 0.01)),
                    seed=int(rng.integers(2**63)))
            req.append((name, s, fam))
        pool.append(req)
    return pool
