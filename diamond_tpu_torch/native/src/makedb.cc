// makedb helpers: chained MurmurHash3 x64-128 over record streams.
//
// The .dmnd header hash chains a 16-byte digest through every record's
// (masked letters, id) pair (reference legacy/dmnd/dmnd.cpp:304-308 with
// the vendored murmurhash's seed-chaining variant,
// lib/murmurhash/MurmurHash3.cpp:269-275).  The Python twin
// (diamond_tpu/utils/murmur3.py) is the oracle; this is the bulk path —
// one call hashes a whole record chunk instead of 2 Python calls per
// record.
#include <cstdint>
#include <cstring>

namespace {

inline uint64_t rotl64(uint64_t x, int8_t r) {
    return (x << r) | (x >> (64 - r));
}

inline uint64_t fmix64(uint64_t k) {
    k ^= k >> 33;
    k *= 0xff51afd7ed558ccdULL;
    k ^= k >> 33;
    k *= 0xc4ceb9fe1a85ec53ULL;
    k ^= k >> 33;
    return k;
}

void murmur3_x64_128(const uint8_t* data, int64_t len, uint8_t* seed_io) {
    uint64_t h1, h2;
    std::memcpy(&h1, seed_io, 8);
    std::memcpy(&h2, seed_io + 8, 8);
    const uint64_t c1 = 0x87c37b91114253d5ULL;
    const uint64_t c2 = 0x4cf5ad432745937fULL;
    const int64_t nblocks = len / 16;
    for (int64_t i = 0; i < nblocks; i++) {
        uint64_t k1, k2;
        std::memcpy(&k1, data + i * 16, 8);
        std::memcpy(&k2, data + i * 16 + 8, 8);
        k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
        h1 = rotl64(h1, 27); h1 += h2; h1 = h1 * 5 + 0x52dce729;
        k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
        h2 = rotl64(h2, 31); h2 += h1; h2 = h2 * 5 + 0x38495ab5;
    }
    const uint8_t* tail = data + nblocks * 16;
    const int64_t t = len & 15;
    uint64_t k1 = 0, k2 = 0;
    switch (t) {
        case 15: k2 ^= uint64_t(tail[14]) << 48; [[fallthrough]];
        case 14: k2 ^= uint64_t(tail[13]) << 40; [[fallthrough]];
        case 13: k2 ^= uint64_t(tail[12]) << 32; [[fallthrough]];
        case 12: k2 ^= uint64_t(tail[11]) << 24; [[fallthrough]];
        case 11: k2 ^= uint64_t(tail[10]) << 16; [[fallthrough]];
        case 10: k2 ^= uint64_t(tail[9]) << 8; [[fallthrough]];
        case 9:
            k2 ^= uint64_t(tail[8]);
            k2 *= c2; k2 = rotl64(k2, 33); k2 *= c1; h2 ^= k2;
            [[fallthrough]];
        case 8: k1 ^= uint64_t(tail[7]) << 56; [[fallthrough]];
        case 7: k1 ^= uint64_t(tail[6]) << 48; [[fallthrough]];
        case 6: k1 ^= uint64_t(tail[5]) << 40; [[fallthrough]];
        case 5: k1 ^= uint64_t(tail[4]) << 32; [[fallthrough]];
        case 4: k1 ^= uint64_t(tail[3]) << 24; [[fallthrough]];
        case 3: k1 ^= uint64_t(tail[2]) << 16; [[fallthrough]];
        case 2: k1 ^= uint64_t(tail[1]) << 8; [[fallthrough]];
        case 1:
            k1 ^= uint64_t(tail[0]);
            k1 *= c1; k1 = rotl64(k1, 31); k1 *= c2; h1 ^= k1;
    }
    h1 ^= uint64_t(len);
    h2 ^= uint64_t(len);
    h1 += h2;
    h2 += h1;
    h1 = fmix64(h1);
    h2 = fmix64(h2);
    h1 += h2;
    h2 += h1;
    std::memcpy(seed_io, &h1, 8);
    std::memcpy(seed_io + 8, &h2, 8);
}

}  // namespace

extern "C" {

// Chain the dmnd header hash through records [0, n): per record, hash
// the masked letters [starts[k], starts[k]+lens[k]) of letters_cat, then
// the id bytes [id_offs[k], id_offs[k+1]) of ids_cat.  hash_io: 16-byte
// digest, updated in place.
void dmnd_hash_records(const int8_t* letters_cat, const int64_t* starts,
                       const int64_t* lens, const int8_t* ids_cat,
                       const int64_t* id_offs, int64_t n,
                       uint8_t* hash_io) {
    for (int64_t k = 0; k < n; k++) {
        murmur3_x64_128(
            reinterpret_cast<const uint8_t*>(letters_cat) + starts[k],
            lens[k], hash_io);
        murmur3_x64_128(
            reinterpret_cast<const uint8_t*>(ids_cat) + id_offs[k],
            id_offs[k + 1] - id_offs[k], hash_io);
    }
}

}  // extern "C"
