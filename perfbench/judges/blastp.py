"""The comparison that decides ``correct`` for a protein search (``blastp``,
with or without ``--swipe``; a configuration names it as its judge
``module``): the program's ``-f 6`` lines of the judged requests against
the plain reference (``reference.py``).

Per hit line (``wrong_hits``): the 13 fields parse, the query and target
are known, the target's id appears once for the query, at most
``max_target_seqs`` lines a query, and the e-value is within
``max_evalue``; the reported raw score equals the reference's best score
of the reported box (query qstart..qend against target sstart..send, end
to end, on the tantan-masked letters with the Hauser bias); the bitscore
and the e-value are the reference's for that score (to their printed
digits); the identities (of the masked letters, as DIAMOND counts them)
lie among those of the paths that reach that score; the length and gap openings fit the box.  With ``exhaustive`` (a
``--swipe`` configuration) the raw score must also be the pair's best
local score.

Per planted family pair (``missed_members``): a judged related query's
database family members whose reference local alignment reaches
``must_find`` (an e-value, and identities over the shorter sequence's
length: 0 for an exhaustive search, which finds every significant pair;
the default sensitivity is built for pairs above 60 % identity) are
reported, unless the query already reports ``max_target_seqs`` targets
that all score higher.

``failed_requests``: requests of the window that exited non-zero.
Each number has the limit 0.
"""
from __future__ import annotations

import math

import numpy as np

import gen
import reference as R

LIMITS = {"wrong_hits": 0, "missed_members": 0, "failed_requests": 0}


def parse_lines(text: str):
    """[(fields...)] of a 13-column -f 6 output; a line that does not
    parse is None."""
    out = []
    for line in text.splitlines():
        f = line.split("\t")
        try:
            out.append((f[0], f[1], float(f[2]), int(f[3]), int(f[4]),
                        int(f[5]), int(f[6]), int(f[7]), int(f[8]),
                        int(f[9]), float(f[10]), float(f[11]), int(f[12])))
        except (IndexError, ValueError):
            out.append(None)
    return out


def _printed(x: float) -> float:
    """The value a bitscore or pident of x >= 0 prints as (BLAST's
    format): floored from 100 up, else to one decimal, halves away from
    zero."""
    return float(math.floor(x)) if x >= 100.0 else math.floor(
        x * 10.0 + 0.5) / 10.0


def judge(requests, db, cfg, device="cpu", control=False):
    """Numbers of the judged requests.

    requests: [(queries [(id, seq, family)], output text)], db: [(id,
    seq)], cfg: the configuration's ``judge`` block.  ``control``: score
    every hit with the 8-bit saturating DP and write that score, its
    bitscore and its e-value into the line first, as a program that kept
    8-bit scores would (the reference in the program's place, one
    precision down).  Returns (numbers, details)."""
    k_max = int(cfg["max_target_seqs"])
    e_max = float(cfg["max_evalue"])
    exhaustive = bool(cfg.get("exhaustive", False))
    must = cfg["must_find"]
    db_index = {name: i for i, (name, _) in enumerate(db)}
    db_letters = sum(len(s) for _, s in db)
    fam_members = {}
    for i, (name, _) in enumerate(db):
        fam_members.setdefault(gen.family_of(name), []).append(i)

    wrong = missed = 0
    details = dict(hits=0, queries=0, pairs=0, wrong=[], missed=[])
    bad = set()        # indices of the requests with a wrong or missed item
    hits = []          # (query key, db index, parsed line)
    q_seqs = {}        # query key -> (plain letters, family)
    per_query = {}     # query key -> [db index]
    for r, (queries, text) in enumerate(requests):
        by_name = {q[0]: q for q in queries}
        for q in queries:
            q_seqs[(r, q[0])] = (R.encode(q[1]), q[2])
            per_query[(r, q[0])] = []
        for h in parse_lines(text):
            if h is None or h[0] not in by_name or h[1] not in db_index:
                wrong += 1
                bad.add(r)
                details["wrong"].append(("unparsed", r, h and h[:2]))
                continue
            key = (r, h[0])
            t = db_index[h[1]]
            if t in per_query[key]:
                wrong += 1
                bad.add(r)
                details["wrong"].append(("duplicate", key, h[1]))
                continue
            per_query[key].append(t)
            hits.append((key, t, h))
    for key, ts in per_query.items():
        if len(ts) > k_max:
            wrong += len(ts) - k_max
            bad.add(key[0])
            details["wrong"].append(("over max_target_seqs", key, len(ts)))

    # masked letters and the bias of every sequence the check reads
    need_t = sorted({t for _, t, _ in hits}
                    | {m for (k, (_, fam)) in q_seqs.items() if fam >= 0
                       for m in fam_members.get(fam, [])})
    t_plain = {t: R.encode(db[t][1]) for t in need_t}
    q_keys = sorted(q_seqs)
    masked = R.repeat_mask([q_seqs[k][0] for k in q_keys]
                           + [t_plain[t] for t in need_t])
    q_mask = dict(zip(q_keys, masked[:len(q_keys)]))
    t_mask = dict(zip(need_t, masked[len(q_keys):]))
    q_bias = {k: R.hauser_bias(q_mask[k]) for k in q_keys}

    # the best local score of every planted family pair of a related query
    fam_pairs = [(k, m) for k in q_keys if q_seqs[k][1] >= 0
                 for m in fam_members.get(q_seqs[k][1], [])]
    local, ident = {}, {}
    if fam_pairs:
        s, hi, _ = R.align([(q_mask[k], q_bias[k], t_mask[m], q_seqs[k][0],
                             t_plain[m]) for k, m in fam_pairs], "local",
                           device)
        local = dict(zip(fam_pairs, s.tolist()))
        # identities of the best local alignment over the shorter sequence
        ident = {p: h / min(len(q_seqs[p[0]][0]), len(t_plain[p[1]]))
                 for p, h in zip(fam_pairs, hi.tolist())}

    # the reported boxes
    box_pairs, ok_box = [], []
    for key, t, h in hits:
        qs, qe, ss, se = h[6:10]
        ok_box.append(0 < qs <= qe <= len(q_seqs[key][0])
                      and 0 < ss <= se <= len(t_plain[t]))
        box_pairs.append((q_mask[key][qs - 1:qe], q_bias[key][qs - 1:qe],
                          t_mask[t][ss - 1:se], q_mask[key][qs - 1:qe],
                          t_mask[t][ss - 1:se]))
    s_box = np.zeros(len(hits), np.int64)
    id_hi, id_lo, s8 = s_box.copy(), s_box.copy(), s_box.copy()
    ok = np.flatnonzero(ok_box)
    if len(ok):
        s_box[ok], id_hi[ok], id_lo[ok] = R.align(
            [box_pairs[n] for n in ok], "box", device)
        if control:
            s8[ok] = R.align([box_pairs[n] for n in ok], "box", device,
                             int8=True)[0]

    reported = {}
    for n, (key, t, h) in enumerate(hits):
        (_, _, pident, length, mism, gapopen, qs, qe, ss, se, ev, bits,
         score) = h
        qlen, slen = len(q_seqs[key][0]), len(t_plain[t])
        if control:
            score = int(s8[n])
            ev = R.evalue(score, qlen, slen, db_letters)
            bits = _printed(R.bitscore(score))
        reported[(key, t)] = score
        why = []
        if not ok_box[n]:
            why.append("box outside the sequences")
        else:
            ref = int(s_box[n])
            ev_ref = R.evalue(ref, qlen, slen, db_letters)
            if score != ref:
                why.append(f"score {score} != box optimum {ref}")
            if abs(bits - _printed(R.bitscore(ref))) > (
                    1.0 if bits >= 100 else 0.1):
                why.append(f"bitscore {bits}")
            if not (abs(ev - ev_ref) <= 0.01 * ev_ref or (ev == 0.0
                                                          and ev_ref < 1e-300)):
                why.append(f"evalue {ev} != {ev_ref:.3e}")
            if ev > e_max:
                why.append(f"evalue {ev} over {e_max}")
            # identities that print as the reported pident, among those of
            # the paths that reach the score; the columns: identities +
            # mismatches + gap columns = length, gap columns = 2 length -
            # the two spans, each gap opening at least one gap column
            ids = [i for i in range(int(id_lo[n]), int(id_hi[n]) + 1)
                   if abs(_printed(i * 100.0 / length) - pident) < 1e-9]
            if not ids:
                why.append(f"pident {pident} outside identities "
                           f"{id_lo[n]}..{id_hi[n]} of {length}")
            qn, sn = qe - qs + 1, se - ss + 1
            gaps = 2 * length - qn - sn
            if not (gaps >= abs(qn - sn) and (gaps > 0) == (gapopen > 0)
                    and gapopen <= gaps
                    and any(i + mism + gaps == length for i in ids)):
                why.append(f"length {length}, mismatches {mism}, gap "
                           f"openings {gapopen} do not fit the box")
            if exhaustive and (key, t) in local and score != local[(key, t)]:
                why.append(f"score {score} != best local {local[(key, t)]}")
        if why:
            wrong += 1
            bad.add(key[0])
            details["wrong"].append((key, db[t][0], why))
    top_missed = 0.0   # identity of the closest family pair not reported
    held = 0           # family pairs held to must_find
    for (key, m), s in local.items():
        qlen, slen = len(q_seqs[key][0]), len(t_plain[m])
        ev = R.evalue(s, qlen, slen, db_letters)
        need = (ev <= float(must["evalue"])
                and ident[(key, m)] >= float(must["identity"]))
        held += need
        if (key, m) in reported:
            continue
        got = [reported[(key, t)] for t in per_query[key]]
        if len(got) >= k_max and min(got) >= s:
            continue
        if ev <= e_max:
            top_missed = max(top_missed, ident[(key, m)])
        if not need:
            continue
        missed += 1
        bad.add(key[0])
        details["missed"].append((key, db[m][0], s))
    details.update(hits=len(hits), queries=len(q_keys), pairs=len(fam_pairs),
                   bad_requests=bad, top_missed_identity=top_missed,
                   held_pairs=held, must_find=must)
    return dict(wrong_hits=wrong, missed_members=missed), details


def summary(details) -> str:
    """One line of what was judged."""
    must = details["must_find"]
    return (f"judged {details['queries']} queries, {details['hits']} hits, "
            f"{details['pairs']} family pairs, {details['held_pairs']} held "
            f"to must_find (e <= {must['evalue']}, identity >= "
            f"{must['identity']}) whether reported or not, closest pair "
            f"missed: identity {details['top_missed_identity']:.3f}")
