// graph_engine.cpp — the port's copy of tpugraph/native/graph_engine.cpp,
// the host-side graph runtime: CSR structure, BCSR tile packing, k-hop
// BFS, RCM ordering, the halo-exchange plan and the label-propagation
// partitioner.  tpugraph_torch/native/__init__.py builds it with g++ into
// build/tpugraph_torch/ at first use (tpugraph's binding writes its .so
// next to its own source) and falls back to numpy without a compiler.
//
// ABI: plain C, consumed via ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <numeric>
#include <unordered_map>
#include <unordered_set>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- CSR build

// Build CSR (indptr[n+1], indices[e]) from COO receiver->sender adjacency.
// rows = receivers, cols = senders (matches ops.message.spmm convention).
// order_out[e] records the permutation from input edge order to CSR order
// so edge-aligned payloads (weights, pair ids) can be permuted alongside.
void coo_to_csr(const int32_t* rows, const int32_t* cols, int64_t e,
                int32_t n, int32_t* indptr, int32_t* indices,
                int32_t* order_out) {
    std::memset(indptr, 0, sizeof(int32_t) * (n + 1));
    for (int64_t i = 0; i < e; ++i) indptr[rows[i] + 1]++;
    for (int32_t i = 0; i < n; ++i) indptr[i + 1] += indptr[i];
    std::vector<int32_t> cursor(indptr, indptr + n);
    for (int64_t i = 0; i < e; ++i) {
        int32_t pos = cursor[rows[i]]++;
        indices[pos] = cols[i];
        order_out[pos] = (int32_t)i;
    }
}

// ------------------------------------------------------------- BCSR packing

// Count nonempty (block x block) tiles of the (rows, cols) sparsity.
int64_t bcsr_count_tiles(const int32_t* rows, const int32_t* cols,
                         const float* w, int64_t e, int32_t n_blocks,
                         int32_t block) {
    std::unordered_map<int64_t, int32_t> seen;
    seen.reserve((size_t)(e / 4 + 1));
    for (int64_t i = 0; i < e; ++i) {
        if (w[i] == 0.0f) continue;
        int64_t key = (int64_t)(rows[i] / block) * n_blocks + cols[i] / block;
        seen.emplace(key, 1);
    }
    return (int64_t)seen.size();
}

// Pack BCSR: tiles [t_pad, block, block] zero-initialised by caller,
// col_blk[t_pad], row_of[t_pad], row_ptr[n_blocks+1].
// Tiles are emitted sorted by (row_block, col_block); padding tiles get
// row_of = n_blocks-1, col_blk = 0 (dead slots after all real rows).
// Returns number of real tiles, or -1 if t_pad is too small.
int64_t bcsr_pack(const int32_t* rows, const int32_t* cols, const float* w,
                  int64_t e, int32_t n_blocks, int32_t block,
                  float* tiles, int32_t* col_blk, int32_t* row_of,
                  int32_t* row_ptr, int64_t t_pad) {
    // map tile key -> slot
    std::unordered_map<int64_t, int64_t> slot;
    slot.reserve((size_t)(e / 4 + 1));
    std::vector<int64_t> keys;
    for (int64_t i = 0; i < e; ++i) {
        if (w[i] == 0.0f) continue;
        int64_t key = (int64_t)(rows[i] / block) * n_blocks + cols[i] / block;
        if (slot.emplace(key, 0).second) keys.push_back(key);
    }
    int64_t t = (int64_t)keys.size();
    if (t > t_pad) return -1;
    std::sort(keys.begin(), keys.end());
    for (int64_t i = 0; i < t; ++i) slot[keys[i]] = i;

    const int64_t tile_sz = (int64_t)block * block;
    for (int64_t i = 0; i < e; ++i) {
        if (w[i] == 0.0f) continue;
        int32_t rb = rows[i] / block, cb = cols[i] / block;
        int64_t s = slot[(int64_t)rb * n_blocks + cb];
        tiles[s * tile_sz + (int64_t)(rows[i] % block) * block +
              (cols[i] % block)] += w[i];
    }
    std::vector<int64_t> counts(n_blocks, 0);
    for (int64_t i = 0; i < t; ++i) {
        int32_t rb = (int32_t)(keys[i] / n_blocks);
        col_blk[i] = (int32_t)(keys[i] % n_blocks);
        row_of[i] = rb;
        counts[rb]++;
    }
    for (int64_t i = t; i < t_pad; ++i) {
        row_of[i] = n_blocks - 1;
        col_blk[i] = 0;
    }
    counts[n_blocks - 1] += t_pad - t;
    row_ptr[0] = 0;
    for (int32_t i = 0; i < n_blocks; ++i)
        row_ptr[i + 1] = row_ptr[i] + (int32_t)counts[i];
    return t;
}

// ---------------------------------------------------- BCSR packing, fused v2

static inline uint16_t f32_to_bf16(float v) {
    uint32_t bits;
    std::memcpy(&bits, &v, 4);
    // round-to-nearest-even
    uint32_t rounded = bits + 0x7fffu + ((bits >> 16) & 1u);
    return (uint16_t)(rounded >> 16);
}

// Count the tiles bcsr_pack_v2 will emit (incl. row padding): per-row-block
// tile counts rounded up to k_pack, empty row blocks get k_pack dead tiles.
int64_t bcsr_count_tiles_v2(const int32_t* rows, const int32_t* cols,
                            const float* w, int64_t e, int32_t n_blocks,
                            int32_t block, int32_t k_pack) {
    if (k_pack < 1) k_pack = 1;
    std::unordered_set<int64_t> seen;
    seen.reserve((size_t)(e / 4 + 1));
    for (int64_t i = 0; i < e; ++i) {
        if (w[i] == 0.0f) continue;
        seen.insert((int64_t)(rows[i] / block) * n_blocks + cols[i] / block);
    }
    std::vector<int64_t> cnt(n_blocks, 0);
    for (int64_t key : seen) cnt[key / n_blocks]++;
    int64_t total = 0;
    for (int32_t b = 0; b < n_blocks; ++b) {
        int64_t c = cnt[b];
        c = c == 0 ? k_pack : ((c + k_pack - 1) / k_pack) * k_pack;
        total += c;
    }
    return total;
}

// Fused packer (r3): emits tiles DIRECTLY at the padded row layout and the
// target dtype, replacing the python pipeline
//   native f32 pack (2.8 GB) -> numpy bf16 cast -> numpy pad copy
// with one pass.  Edges are counting-sorted by destination tile so each
// tile accumulates in a small f32 scratch before one dtype conversion.
// dtype: 0 = float32 out, 1 = bfloat16 out (uint16 buffer),
//        2 = int8 out (round-to-nearest, saturating; exact for
//            unit/integer-weight adjacencies -- the rank-1 degree
//            normalization factors out into x/y scalings).
// Returns emitted tile count, or -1 if t_total mismatches.
int64_t bcsr_pack_v2(const int32_t* rows, const int32_t* cols, const float* w,
                     int64_t e, int32_t n_blocks, int32_t block,
                     int32_t k_pack, int32_t dtype, void* tiles_out,
                     int32_t* col_blk, int32_t* row_of, int32_t* row_ptr,
                     int64_t t_total) {
    if (k_pack < 1) k_pack = 1;
    // tile key -> provisional slot (sorted later)
    std::unordered_map<int64_t, int64_t> slot;
    slot.reserve((size_t)(e / 4 + 1));
    std::vector<int64_t> keys;
    for (int64_t i = 0; i < e; ++i) {
        if (w[i] == 0.0f) continue;
        int64_t key = (int64_t)(rows[i] / block) * n_blocks + cols[i] / block;
        if (slot.emplace(key, 0).second) keys.push_back(key);
    }
    std::sort(keys.begin(), keys.end());
    int64_t t_real = (int64_t)keys.size();

    // padded per-row-block layout
    std::vector<int64_t> cnt(n_blocks, 0);
    for (int64_t key : keys) cnt[key / n_blocks]++;
    std::vector<int64_t> padded(n_blocks);
    int64_t total = 0;
    for (int32_t b = 0; b < n_blocks; ++b) {
        int64_t c = cnt[b];
        padded[b] = c == 0 ? k_pack : ((c + k_pack - 1) / k_pack) * k_pack;
        total += padded[b];
    }
    if (total != t_total) return -1;

    row_ptr[0] = 0;
    for (int32_t b = 0; b < n_blocks; ++b)
        row_ptr[b + 1] = row_ptr[b] + (int32_t)padded[b];
    // dead slots: zero tiles at col 0 of their own row block
    for (int32_t b = 0; b < n_blocks; ++b)
        for (int32_t j = 0; j < (int32_t)padded[b]; ++j) {
            row_of[row_ptr[b] + j] = b;
            col_blk[row_ptr[b] + j] = 0;
        }
    // real tiles: consecutive from their row block's start (keys sorted)
    {
        std::vector<int64_t> cursor(n_blocks);
        for (int32_t b = 0; b < n_blocks; ++b) cursor[b] = row_ptr[b];
        for (int64_t i = 0; i < t_real; ++i) {
            int32_t rb = (int32_t)(keys[i] / n_blocks);
            int64_t s = cursor[rb]++;
            slot[keys[i]] = s;
            col_blk[s] = (int32_t)(keys[i] % n_blocks);
        }
    }

    // counting-sort edges by destination slot
    std::vector<int64_t> hist(t_total + 1, 0);
    std::vector<int64_t> edge_slot(e);
    for (int64_t i = 0; i < e; ++i) {
        if (w[i] == 0.0f) { edge_slot[i] = -1; continue; }
        int64_t key = (int64_t)(rows[i] / block) * n_blocks + cols[i] / block;
        int64_t s = slot[key];
        edge_slot[i] = s;
        hist[s + 1]++;
    }
    for (int64_t s = 0; s < t_total; ++s) hist[s + 1] += hist[s];
    std::vector<int64_t> order(hist[t_total]);
    {
        std::vector<int64_t> cursor(hist.begin(), hist.end() - 1);
        for (int64_t i = 0; i < e; ++i)
            if (edge_slot[i] >= 0) order[cursor[edge_slot[i]]++] = i;
    }

    // per-tile f32 accumulate + one dtype conversion into the output;
    // each slot is independent -> OpenMP across the (2) host cores.
    const int64_t tile_sz = (int64_t)block * block;
#ifdef _OPENMP
#pragma omp parallel
#endif
    {
        std::vector<float> scratch(tile_sz);
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 64)
#endif
        for (int64_t s = 0; s < t_total; ++s) {
            int64_t lo = hist[s], hi = hist[s + 1];
            if (lo == hi) {  // dead slot: zero tile
                if (dtype == 2)
                    std::memset((int8_t*)tiles_out + s * tile_sz, 0,
                                (size_t)tile_sz);
                else if (dtype == 1)
                    std::memset((uint16_t*)tiles_out + s * tile_sz, 0,
                                (size_t)tile_sz * 2);
                else
                    std::memset((float*)tiles_out + s * tile_sz, 0,
                                (size_t)tile_sz * 4);
                continue;
            }
            std::fill(scratch.begin(), scratch.end(), 0.0f);
            for (int64_t p = lo; p < hi; ++p) {
                int64_t i = order[p];
                scratch[(int64_t)(rows[i] % block) * block
                        + (cols[i] % block)] += w[i];
            }
            if (dtype == 2) {
                int8_t* out = (int8_t*)tiles_out + s * tile_sz;
                for (int64_t j = 0; j < tile_sz; ++j) {
                    float v = scratch[j];
                    v = v > 127.f ? 127.f : (v < -127.f ? -127.f : v);
                    out[j] = (int8_t)lrintf(v);
                }
            } else if (dtype == 1) {
                uint16_t* out = (uint16_t*)tiles_out + s * tile_sz;
                // round-to-nearest-even on the raw bits; plain uint32
                // loop so gcc auto-vectorizes it (built with
                // -fno-strict-aliasing)
                const uint32_t* bits =
                    reinterpret_cast<const uint32_t*>(scratch.data());
                for (int64_t j = 0; j < tile_sz; ++j) {
                    uint32_t b = bits[j];
                    out[j] = (uint16_t)((b + 0x7fffu + ((b >> 16) & 1u))
                                        >> 16);
                }
            } else {
                std::memcpy((float*)tiles_out + s * tile_sz, scratch.data(),
                            (size_t)tile_sz * 4);
            }
        }
    }
    return t_real;
}

// ---------------------------------------------------------------- k-hop BFS

// Mark all nodes within k hops of src (inclusive) in out_mask[n].
void khop_bfs(const int32_t* indptr, const int32_t* indices, int32_t n,
              int32_t src, int32_t k, uint8_t* out_mask) {
    std::memset(out_mask, 0, n);
    if (src < 0 || src >= n) return;
    std::vector<int32_t> frontier{src}, next;
    out_mask[src] = 1;
    for (int32_t hop = 0; hop < k && !frontier.empty(); ++hop) {
        next.clear();
        for (int32_t u : frontier) {
            for (int32_t p = indptr[u]; p < indptr[u + 1]; ++p) {
                int32_t v = indices[p];
                if (!out_mask[v]) {
                    out_mask[v] = 1;
                    next.push_back(v);
                }
            }
        }
        frontier.swap(next);
    }
}

// Batched BFS: masks for q query nodes into out_masks[q * n].
void khop_bfs_batch(const int32_t* indptr, const int32_t* indices, int32_t n,
                    const int32_t* srcs, int32_t q, int32_t k,
                    uint8_t* out_masks) {
    for (int32_t i = 0; i < q; ++i)
        khop_bfs(indptr, indices, n, srcs[i], k, out_masks + (int64_t)i * n);
}

// ------------------------------------------------------------- halo planning
//
// Node-partitioned SPMD: nodes split into n_dev contiguous shards of size
// ns; device d owns the edges targeting its shard.  The plan records, per
// (sender, receiver-device) pair, which boundary nodes must be exchanged,
// and for each edge where its sender feature lands in the concatenated
// [local | halo] buffer.  (Replaces the O(E) Python loops of
// parallel/spmd.py:build_halo_plan — minutes at PPI scale, milliseconds
// here.)

// Pass 1: raw (unpadded) sizes — max per-device edge count and max
// per-(device, peer) boundary set size.
void halo_plan_sizes(const int32_t* s, const int32_t* r, const float* w,
                     int64_t e, int32_t ns, int32_t n_dev,
                     int64_t* e_max_out, int64_t* h_max_out) {
    std::vector<int64_t> ecnt(n_dev, 0);
    std::vector<std::unordered_set<int32_t>> needed((size_t)n_dev * n_dev);
    for (int64_t i = 0; i < e; ++i) {
        if (w[i] == 0.0f) continue;
        int32_t d = r[i] / ns;
        ecnt[d]++;
        int32_t o = s[i] / ns;
        if (o != d) needed[(size_t)d * n_dev + o].insert(s[i]);
    }
    int64_t em = 0, hm = 0;
    for (int64_t c : ecnt) em = std::max(em, c);
    for (auto& st : needed) hm = std::max(hm, (int64_t)st.size());
    *e_max_out = em;
    *h_max_out = hm;
}

// Pass 2: fill plan arrays (caller zero-initializes; e_max/h are the
// caller-padded sizes).  send_idx [n_dev, n_dev, h]: row o = boundary
// node LOCAL indices device o sends each peer.  sender_slot /
// receivers_local / weights [n_dev, e_max]: per-edge aggregation inputs.
void halo_plan_fill(const int32_t* s, const int32_t* r, const float* w,
                    int64_t e, int32_t ns, int32_t n_dev,
                    int64_t e_max, int64_t h,
                    int32_t* send_idx, int32_t* sender_slot,
                    int32_t* receivers_local, float* weights) {
    std::vector<std::unordered_set<int32_t>> needed((size_t)n_dev * n_dev);
    for (int64_t i = 0; i < e; ++i) {
        if (w[i] == 0.0f) continue;
        int32_t d = r[i] / ns, o = s[i] / ns;
        if (o != d) needed[(size_t)d * n_dev + o].insert(s[i]);
    }
    // recv[d]: global node id -> slot in d's received-halo buffer
    std::vector<std::unordered_map<int32_t, int32_t>> recv((size_t)n_dev);
    std::vector<int32_t> lst;
    for (int32_t d = 0; d < n_dev; ++d) {
        for (int32_t o = 0; o < n_dev; ++o) {
            auto& st = needed[(size_t)d * n_dev + o];
            lst.assign(st.begin(), st.end());
            std::sort(lst.begin(), lst.end());
            for (size_t j = 0; j < lst.size(); ++j) {
                send_idx[((size_t)o * n_dev + d) * h + j] = lst[j] - o * ns;
                recv[d][lst[j]] = (int32_t)(o * h + j);
            }
        }
    }
    std::vector<int64_t> cursor(n_dev, 0);
    for (int64_t i = 0; i < e; ++i) {
        if (w[i] == 0.0f) continue;
        int32_t d = r[i] / ns;
        int64_t k = cursor[d]++;
        int32_t snd = s[i];
        sender_slot[(size_t)d * e_max + k] =
            (snd / ns == d) ? snd - d * ns : (int32_t)(ns + recv[d][snd]);
        receivers_local[(size_t)d * e_max + k] = r[i] - d * ns;
        weights[(size_t)d * e_max + k] = w[i];
    }
}

// --------------------------------------------------- RCM bandwidth reduction

// Reverse Cuthill-McKee ordering over the CSR structure.
// perm_out[new_id] = old_id.  Components are seeded at their minimum-degree
// node; within each BFS level neighbors are visited in ascending degree.
// Relabeling nodes by this order clusters edges near the diagonal, which
// is what makes real (non-banded) graphs pack into dense BCSR tiles for
// the Pallas SpMM — the bandwidth of the reordered matrix bounds how many
// column blocks any row block touches.
void rcm_order(const int32_t* indptr, const int32_t* indices, int32_t n,
               int32_t* perm_out) {
    std::vector<int32_t> deg(n);
    for (int32_t i = 0; i < n; ++i) deg[i] = indptr[i + 1] - indptr[i];
    std::vector<int32_t> seeds(n);
    for (int32_t i = 0; i < n; ++i) seeds[i] = i;
    std::sort(seeds.begin(), seeds.end(), [&](int32_t a, int32_t b) {
        return deg[a] != deg[b] ? deg[a] < deg[b] : a < b;
    });

    std::vector<uint8_t> visited(n, 0);
    std::vector<int32_t> order;
    order.reserve(n);
    std::vector<int32_t> nbr;
    for (int32_t s : seeds) {
        if (visited[s]) continue;
        size_t head = order.size();
        order.push_back(s);
        visited[s] = 1;
        while (head < order.size()) {
            int32_t u = order[head++];
            nbr.clear();
            for (int32_t p = indptr[u]; p < indptr[u + 1]; ++p) {
                int32_t v = indices[p];
                if (!visited[v]) {
                    visited[v] = 1;
                    nbr.push_back(v);
                }
            }
            std::sort(nbr.begin(), nbr.end(), [&](int32_t a, int32_t b) {
                return deg[a] != deg[b] ? deg[a] < deg[b] : a < b;
            });
            order.insert(order.end(), nbr.begin(), nbr.end());
        }
    }
    std::reverse(order.begin(), order.end());
    std::memcpy(perm_out, order.data(), sizeof(int32_t) * n);
}

// ------------------------------------------------ locality-aware partitioning
//
// Balanced label propagation (Spinner-style): start from a balanced seed
// assignment and iteratively move each node to the partition holding the
// majority of its neighbors, under per-partition capacity caps on BOTH
// node count and in-edge mass.  This greedily minimizes exactly the
// objective that sets halo traffic in the node-partitioned SPMD paths:
// the number of cut edges (every cut edge makes its sender a boundary
// node some device must receive).  Reference analog: none (the reference
// is dense single-device, train.py:180-186); this is SURVEY §7's
// "partition edges to minimize boundary nodes" hard part.
//
// s/r/w: directed COO edges (w==0 = padding, skipped).  assign[n] carries
// the seed partition ids in and the refined result out.  Asynchronous
// updates in a fixed LCG-scrambled node order (deterministic).  Returns
// the total number of moves applied.
int64_t label_prop_partition(const int32_t* s, const int32_t* r,
                             const float* w, int64_t e, int32_t n,
                             int32_t n_dev, int32_t iters, float slack,
                             int32_t* assign) {
    // undirected CSR (both edge directions): locality counts an edge
    // whichever way it points
    std::vector<int64_t> indptr((size_t)n + 1, 0);
    std::vector<double> inmass(n, 0.0);
    int64_t live = 0;
    for (int64_t i = 0; i < e; ++i) {
        if (w[i] == 0.0f) continue;
        indptr[(size_t)s[i] + 1]++;
        indptr[(size_t)r[i] + 1]++;
        inmass[r[i]] += 1.0;
        live++;
    }
    for (int32_t i = 0; i < n; ++i) indptr[(size_t)i + 1] += indptr[i];
    std::vector<int32_t> adj((size_t)2 * live);
    {
        std::vector<int64_t> cur(indptr.begin(), indptr.end() - 1);
        for (int64_t i = 0; i < e; ++i) {
            if (w[i] == 0.0f) continue;
            adj[(size_t)cur[s[i]]++] = r[i];
            adj[(size_t)cur[r[i]]++] = s[i];
        }
    }

    const int64_t cap_nodes =
        (int64_t)((double)n / n_dev * slack) + 1;
    const double cap_mass = (double)live / n_dev * slack + 1.0;
    std::vector<int64_t> part_nodes(n_dev, 0);
    std::vector<double> part_mass(n_dev, 0.0);
    for (int32_t i = 0; i < n; ++i) {
        part_nodes[assign[i]]++;
        part_mass[assign[i]] += inmass[i];
    }

    // deterministic scrambled visit order: odd stride coprime with n
    int64_t stride = ((int64_t)n * 2) / 3;
    stride |= 1;
    while (std::gcd(stride, (int64_t)n) != 1) stride += 2;

    std::vector<int32_t> cnt(n_dev);
    int64_t moves_total = 0;
    for (int32_t it = 0; it < iters; ++it) {
        int64_t moves = 0;
        for (int64_t k = 0; k < n; ++k) {
            int32_t u = (int32_t)((k * stride + it) % n);
            int64_t b = indptr[u], q = indptr[(size_t)u + 1];
            if (q == b) continue;
            std::fill(cnt.begin(), cnt.end(), 0);
            for (int64_t p = b; p < q; ++p) cnt[assign[adj[p]]]++;
            int32_t cur = assign[u], best = cur;
            for (int32_t d = 0; d < n_dev; ++d)
                if (cnt[d] > cnt[best]) best = d;
            if (best == cur || cnt[best] == cnt[cur]) continue;
            if (part_nodes[best] + 1 > cap_nodes) continue;
            if (part_mass[best] + inmass[u] > cap_mass) continue;
            part_nodes[cur]--;
            part_nodes[best]++;
            part_mass[cur] -= inmass[u];
            part_mass[best] += inmass[u];
            assign[u] = best;
            moves++;
        }
        moves_total += moves;
        if (moves == 0) break;
    }
    return moves_total;
}

// Cut statistics for a partition assignment: cut edges and, per device,
// the number of DISTINCT remote senders its edges reference (= halo rows
// it must receive — the quantity the halo plan pads to the max of).
void partition_cut_stats(const int32_t* s, const int32_t* r, const float* w,
                         int64_t e, int32_t n, int32_t n_dev,
                         const int32_t* assign,
                         int64_t* cut_out, int64_t* recv_rows_out) {
    std::vector<std::unordered_set<int32_t>> needed((size_t)n_dev);
    int64_t cut = 0;
    for (int64_t i = 0; i < e; ++i) {
        if (w[i] == 0.0f) continue;
        int32_t d = assign[r[i]], o = assign[s[i]];
        if (o != d) {
            cut++;
            needed[d].insert(s[i]);
        }
    }
    *cut_out = cut;
    for (int32_t d = 0; d < n_dev; ++d)
        recv_rows_out[d] = (int64_t)needed[d].size();
}

// ------------------------------------------------------- degree + normalize

// Symmetric normalization in place: w[i] /= sqrt(deg[rows[i]]*deg[cols[i]]).
void sym_normalize(const int32_t* rows, const int32_t* cols, float* w,
                   int64_t e, int32_t n) {
    std::vector<double> deg(n, 0.0);
    for (int64_t i = 0; i < e; ++i) deg[rows[i]] += w[i];
    std::vector<double> inv(n, 0.0);
    for (int32_t i = 0; i < n; ++i)
        if (deg[i] > 0) inv[i] = 1.0 / std::sqrt(deg[i]);
    for (int64_t i = 0; i < e; ++i)
        w[i] = (float)(w[i] * inv[rows[i]] * inv[cols[i]]);
}

}  // extern "C"
