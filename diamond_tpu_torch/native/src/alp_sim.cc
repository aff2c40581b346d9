// Smith-Waterman island decomposition for the gapped Gumbel parameter
// simulation (native twin of diamond_tpu/stats/alp.py
// _sim_pair_islands; the island method of Altschul et al., NAR 29:351
// (2001), replacing the reference's ALP library for custom matrices).
//
// Each positive cell inherits the island of the predecessor realizing
// its maximum; zero cells reset.  Returns the number of islands and
// writes each island's best score.

#include <cstdint>
#include <vector>

extern "C" int64_t sw_islands(
    const int8_t* q, int64_t qlen, const int8_t* t, int64_t tlen,
    const int32_t* matrix20 /* [20][20] */, int64_t go, int64_t ge,
    int32_t* out_scores, int64_t cap) {
    std::vector<int64_t> H(qlen + 1, 0), E(qlen + 1, 0);
    std::vector<int64_t> Hid(qlen + 1, -1), Eid(qlen + 1, -1);
    std::vector<int32_t> best;
    best.reserve(1024);
    std::vector<int64_t> diagH(qlen + 1), diagId(qlen + 1);
    for (int64_t j = 0; j < tlen; ++j) {
        const int32_t* col = matrix20 + t[j];
        diagH = H;
        diagId = Hid;
        int64_t Fv = 0, Fid = -1;
        for (int64_t i = 1; i <= qlen; ++i) {
            const int64_t ev_ext = E[i] - ge;
            const int64_t ev_opn = H[i] - go;
            const int64_t Ev = ev_ext >= ev_opn ? ev_ext : ev_opn;
            const int64_t EvId = ev_ext >= ev_opn ? Eid[i] : Hid[i];
            int64_t c = diagH[i - 1] + col[(int64_t)q[i - 1] * 20];
            int64_t cid = diagId[i - 1];
            if (Ev > c) {
                c = Ev;
                cid = EvId;
            }
            if (Fv > c) {
                c = Fv;
                cid = Fid;
            }
            if (c <= 0) {
                c = 0;
                cid = -1;
            } else {
                if (cid == -1) {
                    best.push_back(0);
                    cid = (int64_t)best.size() - 1;
                }
                if (c > best[cid])
                    best[cid] = (int32_t)c;
            }
            // store E for next column BEFORE overwriting H
            E[i] = Ev;
            Eid[i] = EvId;
            H[i] = c;
            Hid[i] = cid;
            const int64_t f_ext = Fv - ge;
            const int64_t f_opn = c - go;
            if (f_ext >= f_opn) {
                Fv = f_ext;
            } else {
                Fv = f_opn;
                Fid = cid;
            }
        }
    }
    const int64_t n = (int64_t)best.size() < cap ? (int64_t)best.size() : cap;
    for (int64_t k = 0; k < n; ++k)
        out_scores[k] = best[k];
    return n;
}
