// Native host-side trie draft cache.
//
// The port's own copy of painlessinferenceacceleration_tpu/csrc/trie.cpp: a
// semantics-equivalent C++ implementation of lookahead/trie.py (which
// rebuilds the reference's lookahead/common/lookahead_cache.py). The trie
// query sits on the host critical path of LookaheadGenerator (its qts
// statistic); the Python version costs ~20ms per 512-token put and ~50us
// per hier_get, so this version exists to keep host work under the
// device's verify step.
//
// Exposed as a C ABI consumed via ctypes. lookahead/native.py builds it with
// g++ -O2 -std=c++17 -shared -fPIC into build/ beside the package, the file
// name carrying a hash of this source. Differentially tested against the
// port's Python trie in tests/test_torch_generate.py.

#include <algorithm>
#include <cstdio>
#include <cstdint>
#include <cstring>
#include <map>
#include <set>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Node {
    std::unordered_map<int32_t, Node*> kids;
    std::vector<int32_t> kid_order;  // python-dict insertion-order parity
    double out_freq = 0.0;
    std::unordered_map<int32_t, double> in_freqs;

    double freq_in(int32_t idx) const {
        auto it = in_freqs.find(idx);
        return it == in_freqs.end() ? 0.0 : it->second;
    }
    ~Node() {
        for (auto& kv : kids) delete kv.second;
    }
};

struct TokenTrie {
    int32_t token_id;
    int64_t max_node, max_output_node;
    int64_t n_node = 0, n_output_node = 0;
    std::unordered_map<int32_t, Node*> root;
    std::vector<int32_t> root_order_;

    TokenTrie(int32_t tid, int64_t mn, int64_t mon)
        : token_id(tid), max_node(mn), max_output_node(mon) {}
    ~TokenTrie() {
        for (auto& kv : root) delete kv.second;
    }

    void put(const int32_t* ids, int n, int mode /*0 out, 1 in*/, int32_t idx) {
        auto* nodes = &root;
        int64_t fresh = 0;
        Node* parent = nullptr;
        for (int i = 0; i < n; ++i) {
            Node*& slot = (*nodes)[ids[i]];
            if (slot == nullptr) {
                slot = new Node();
                ++fresh;
                if (parent != nullptr)
                    parent->kid_order.push_back(ids[i]);
                else
                    root_order_.push_back(ids[i]);
            }
            if (mode == 0)
                slot->out_freq += 1.0;
            else
                slot->in_freqs[idx] += 1.0;
            parent = slot;
            nodes = &slot->kids;
        }
        n_node += fresh;
        if (mode == 0) n_output_node += fresh;
    }

    // walk the query suffix through freq-positive nodes
    struct WalkResult {
        int32_t last;
        std::unordered_map<int32_t, Node*>* nodes;
        const std::vector<int32_t>* order;
    };

    WalkResult walk(const int32_t* q, int qn, int mode, int32_t idx) {
        auto* nodes = &root;
        const std::vector<int32_t>* order = &root_order_;
        int32_t last = INT32_MIN;
        for (int i = 0; i < qn; ++i) {
            last = q[i];
            auto it = nodes->find(q[i]);
            if (it == nodes->end()) return {last, nullptr, nullptr};
            Node* nd = it->second;
            bool alive;
            if (mode == 1)
                alive = nd->freq_in(idx) > 0;
            else if (mode == 2)
                alive = nd->out_freq > 0;
            else
                alive = nd->freq_in(idx) > 0 || nd->out_freq > 0;
            if (!alive) return {last, nullptr, nullptr};
            nodes = &nd->kids;
            order = &nd->kid_order;
        }
        return {last, nodes, order};
    }

    struct Freq3 {
        double fi, fo, fm;
    };

    void collect_freqs(std::unordered_map<int32_t, Node*>* nodes,
                       const std::vector<int32_t>* order, int32_t idx,
                       double w_out, std::vector<Freq3>& out) {
        struct Frame {
            std::unordered_map<int32_t, Node*>* kids;
            const std::vector<int32_t>* order;
        };
        std::vector<Frame> stack{{nodes, order}};
        while (!stack.empty()) {
            Frame f = stack.back();
            stack.pop_back();
            for (int32_t tok : *f.order) {
                auto it = f.kids->find(tok);
                if (it == f.kids->end()) continue;  // evicted by squeeze
                Node* nd = it->second;
                double fi = nd->freq_in(idx), fo = nd->out_freq;
                if (fi > 0 || fo > 0) {
                    out.push_back({fi, fo, (1.0 - w_out) * fi + w_out * fo});
                    if (!nd->kids.empty())
                        stack.push_back({&nd->kids, &nd->kid_order});
                }
            }
        }
    }

    // thresholds mirroring trie.py _thresholds
    void thresholds(std::vector<Freq3>& freqs, int max_size, int min_input_size,
                    int min_output_size, int mode, double& min_in,
                    double& min_out, double& min_mix) {
        const double BIG = 1e9;
        min_in = min_out = min_mix = BIG;
        auto count_live = [&](auto pred) {
            int c = 0;
            for (auto& f : freqs)
                if (pred(f)) ++c;
            return c;
        };
        if (mode == 1) {
            int live = count_live([](const Freq3& f) { return f.fi > 0; });
            if (live > max_size) {
                std::vector<double> v;
                for (auto& f : freqs) v.push_back(f.fi);
                std::sort(v.begin(), v.end(), std::greater<double>());
                min_in = v[std::max(min_input_size - 1, 0)];
            } else
                min_in = 0.0;
        } else if (mode == 2) {
            int live = count_live([](const Freq3& f) { return f.fo > 0; });
            if (live > max_size) {
                std::vector<double> v;
                for (auto& f : freqs) v.push_back(f.fo);
                std::sort(v.begin(), v.end(), std::greater<double>());
                min_out = v[std::max(min_output_size - 1, 0)];
            } else
                min_out = 0.0;
        } else {
            int live = count_live([](const Freq3& f) { return f.fi > 0 || f.fo > 0; });
            if (live > max_size) {
                std::set<int> chosen;
                std::vector<int> order(freqs.size());
                for (size_t i = 0; i < freqs.size(); ++i) order[i] = (int)i;
                if (min_input_size > 0) {
                    auto byin = order;
                    std::stable_sort(byin.begin(), byin.end(), [&](int a, int b) {
                        return freqs[a].fi > freqs[b].fi;
                    });
                    min_in = freqs[byin[min_input_size - 1]].fi;
                    for (int i = 0; i < min_input_size; ++i) chosen.insert(byin[i]);
                }
                if (min_output_size > 0) {
                    auto byout = order;
                    std::stable_sort(byout.begin(), byout.end(), [&](int a, int b) {
                        return freqs[a].fo > freqs[b].fo;
                    });
                    min_out = freqs[byout[min_output_size - 1]].fo;
                    for (int i = 0; i < min_output_size; ++i) chosen.insert(byout[i]);
                }
                if ((int)chosen.size() < max_size) {
                    auto bymix = order;
                    std::stable_sort(bymix.begin(), bymix.end(), [&](int a, int b) {
                        return freqs[a].fm > freqs[b].fm;
                    });
                    int rest = max_size - (int)chosen.size();
                    for (int i = 0; i < rest && i < (int)bymix.size(); ++i)
                        chosen.insert(bymix[i]);
                    int n = (int)chosen.size();
                    for (int i = rest; i < std::min(rest + max_size, live); ++i) {
                        if (chosen.count(bymix[i])) continue;
                        ++n;
                        if (n >= max_size) {
                            min_mix = freqs[bymix[i]].fm;
                            break;
                        }
                    }
                }
            } else
                min_mix = 0.0;
        }
    }

    // pre-order ravel, hottest child first (trie.py expand)
    void expand(std::unordered_map<int32_t, Node*>* kids,
                const std::vector<int32_t>* order, int pid, int depth,
                int max_size, int mode, int32_t idx, double w_out,
                double min_in, double min_out, double min_mix,
                std::vector<int32_t>& ids, std::vector<int32_t>& parents,
                std::vector<uint8_t>& mask, int mstride, int32_t* sizes) {
        if (depth <= 0 || (int)ids.size() >= max_size) return;
        std::vector<std::pair<double, std::pair<int32_t, Node*>>> ranked;
        ranked.reserve(kids->size());
        for (int32_t tok : *order) {
            auto it = kids->find(tok);
            if (it == kids->end()) continue;
            Node* nd = it->second;
            double score =
                (1.0 - w_out) * nd->freq_in(idx) + w_out * nd->out_freq;
            ranked.push_back({score, {tok, nd}});
        }
        std::stable_sort(ranked.begin(), ranked.end(),
                         [](auto& a, auto& b) { return a.first > b.first; });
        for (auto& r : ranked) {
            if ((int)ids.size() >= max_size) return;
            Node* nd = r.second.second;
            double fi = nd->freq_in(idx), fo = nd->out_freq;
            double fm = (1.0 - w_out) * fi + w_out * fo;
            if (mode == 0) {
                if (fi <= 0 && fo <= 0) continue;
                if (fi < min_in && fo < min_out && fm < min_mix) continue;
            } else if (mode == 1) {
                if (fi <= 0 || fi < min_in) continue;
            } else {
                if (fo <= 0 || fo < min_out) continue;
            }
            if (fi > 0) ++sizes[0];
            if (fo > 0) ++sizes[1];
            int rid = (int)ids.size();
            ids.push_back(r.second.first);
            parents.push_back(pid);
            std::memcpy(&mask[rid * mstride], &mask[pid * mstride], mstride);
            mask[rid * mstride + rid] = 1;
            if (!nd->kids.empty())
                expand(&nd->kids, &nd->kid_order, rid, depth - 1, max_size,
                       mode, idx, w_out, min_in, min_out, min_mix, ids,
                       parents, mask, mstride, sizes);
        }
    }

    int get(const int32_t* q, int qn, int max_size, int max_length,
            int min_input_size, int min_output_size, double output_weight,
            int mode, int32_t idx, int32_t* out_ids, uint8_t* out_mask,
            int32_t* out_parents, int32_t* out_sizes) {
        auto w = walk(q, qn, mode, idx);
        int32_t rootid = (w.last == INT32_MIN) ? token_id : w.last;
        out_sizes[0] = out_sizes[1] = 0;
        if (w.nodes == nullptr || w.nodes->empty()) {
            out_ids[0] = rootid;
            out_mask[0] = 1;
            out_parents[0] = -1;
            return 1;
        }
        double w_out = mode == 1 ? 0.0 : (mode == 2 ? 1.0 : output_weight);
        std::vector<Freq3> freqs;
        collect_freqs(w.nodes, w.order, idx, output_weight, freqs);
        double min_in, min_out, min_mix;
        thresholds(freqs, max_size, min_input_size, min_output_size, mode,
                   min_in, min_out, min_mix);
        std::vector<int32_t> ids{rootid};
        std::vector<int32_t> parents{-1};
        std::vector<uint8_t> mask(max_size * max_size, 0);
        for (int r = 0; r < max_size; ++r) mask[r * max_size] = 1;
        expand(w.nodes, w.order, 0, max_length, max_size, mode, idx, w_out,
               min_in, min_out, min_mix, ids, parents, mask, max_size,
               out_sizes);
        int n = (int)ids.size();
        for (int i = 0; i < n; ++i) {
            out_ids[i] = ids[i];
            out_parents[i] = parents[i];
            std::memcpy(&out_mask[i * n], &mask[i * max_size], n);
        }
        return n;
    }

    int get_one_branch(const int32_t* q, int qn, int max_length, int mode,
                       int32_t idx, int32_t* out_ids, uint8_t* out_mask,
                       int32_t* out_parents, int32_t* out_sizes) {
        auto w = walk(q, qn, mode, idx);
        int32_t rootid = (w.last == INT32_MIN) ? token_id : w.last;
        out_sizes[0] = out_sizes[1] = 0;
        std::vector<int32_t> ids{rootid};
        if (w.nodes != nullptr) {
            auto* cur = w.nodes;
            const std::vector<int32_t>* order = w.order;
            int depth = 0;
            while (cur != nullptr && !cur->empty() && depth < max_length) {
                double best_f = 0.0;
                Node* best = nullptr;
                int32_t best_tok = 0;
                for (int32_t tok : *order) {
                    auto it = cur->find(tok);
                    if (it == cur->end()) continue;
                    double fi = it->second->freq_in(idx), fo = it->second->out_freq;
                    double f;
                    if (mode == 1)
                        f = fi > 0 ? fi : 0.0;
                    else if (mode == 2)
                        f = fo > 0 ? fo : 0.0;
                    else
                        f = (fi > 0 || fo > 0) ? 10000.0 * fi + fo : 0.0;
                    if (f > best_f) {
                        best_f = f;
                        best = it->second;
                        best_tok = tok;
                    }
                }
                if (best == nullptr) break;
                ids.push_back(best_tok);
                order = &best->kid_order;
                cur = &best->kids;
                ++depth;
            }
            out_sizes[0] = depth;
        }
        int n = (int)ids.size();
        for (int i = 0; i < n; ++i) {
            out_ids[i] = ids[i];
            out_parents[i] = i - 1;
            for (int j = 0; j < n; ++j) out_mask[i * n + j] = j <= i ? 1 : 0;
        }
        return n;
    }

    void squeeze() {
        if (n_node <= max_node && n_output_node <= max_output_node) return;
        squeeze_rec(root, root_order_);
        n_node = n_output_node = count(root);
    }

    // Evicted tokens also leave their parent's insertion order, so that a
    // token inserted again comes last, as in a Python dict (the JAX
    // package's copy keeps the stale entry: the token is then visited at
    // its old place, and twice).
    static void squeeze_rec(std::unordered_map<int32_t, Node*>& nodes,
                            std::vector<int32_t>& order) {
        for (auto it = nodes.begin(); it != nodes.end();) {
            Node* nd = it->second;
            if (nd->out_freq > 1.0) {
                nd->out_freq *= 0.5;
                if (!nd->kids.empty()) squeeze_rec(nd->kids, nd->kid_order);
                ++it;
            } else {
                delete nd;
                it = nodes.erase(it);
            }
        }
        order.erase(std::remove_if(order.begin(), order.end(),
                                   [&nodes](int32_t t) { return nodes.count(t) == 0; }),
                    order.end());
    }

    static int64_t count(std::unordered_map<int32_t, Node*>& nodes) {
        int64_t n = (int64_t)nodes.size();
        for (auto& kv : nodes)
            if (!kv.second->kids.empty()) n += count(kv.second->kids);
        return n;
    }

    void reset_input_freq(int32_t idx) { reset_rec(root, idx); }

    static void reset_rec(std::unordered_map<int32_t, Node*>& nodes, int32_t idx) {
        for (auto& kv : nodes) {
            auto it = kv.second->in_freqs.find(idx);
            if (it != kv.second->in_freqs.end() && it->second != 0.0) {
                it->second = 0.0;
                if (!kv.second->kids.empty()) reset_rec(kv.second->kids, idx);
            }
        }
    }
};

struct Cache {
    std::unordered_set<int32_t> eos_ids;
    std::unordered_set<int32_t> stop_words;
    int64_t max_node, max_output_node;
    int64_t squeeze_every;
    std::unordered_map<int32_t, TokenTrie*> mem;
    std::unordered_map<int32_t, std::vector<int32_t>> stream_buf;
    std::unordered_set<int32_t> touched;
    std::unordered_set<int32_t> touched_input;

    Cache(const int32_t* eos, int n_eos, int64_t mn, int64_t mon, int64_t sq)
        : max_node(mn), max_output_node(mon), squeeze_every(sq) {
        for (int i = 0; i < n_eos; ++i) eos_ids.insert(eos[i]);
    }
    ~Cache() {
        for (auto& kv : mem) delete kv.second;
    }

    TokenTrie* tree(int32_t tok) {
        auto it = mem.find(tok);
        if (it != mem.end()) return it->second;
        auto* t = new TokenTrie(tok, max_node, max_output_node);
        mem[tok] = t;
        return t;
    }

    std::vector<int32_t> trunc(const int32_t* ids, int n) {
        std::vector<int32_t> out;
        out.reserve(n);
        for (int i = 0; i < n; ++i) {
            if (eos_ids.count(ids[i])) break;
            out.push_back(ids[i]);
        }
        return out;
    }

    void finalize(int32_t idx) {
        for (int32_t tok : touched_input) {
            auto it = mem.find(tok);
            if (it != mem.end()) it->second->reset_input_freq(idx);
        }
        touched_input.clear();
        if ((int64_t)touched.size() >= squeeze_every) {
            for (int32_t tok : touched) {
                auto it = mem.find(tok);
                if (it != mem.end()) it->second->squeeze();
            }
            touched.clear();
        }
    }

    void put(const int32_t* ids_in, int n, int branch_length, int final,
             int mode, int32_t idx) {
        auto ids = trunc(ids_in, n);
        if ((int)ids.size() >= 2) {
            for (int i = 0; i + 1 < (int)ids.size(); ++i) {
                if (stop_words.count(ids[i])) continue;
                int m = std::min((int)ids.size() - (i + 1), branch_length);
                tree(ids[i])->put(&ids[i + 1], m, mode, idx);
                touched.insert(ids[i]);
                if (mode == 1) touched_input.insert(ids[i]);
            }
        }
        if (final) finalize(idx);
    }

    void stream_put(const int32_t* ids_in, int n, int branch_length, int final,
                    int32_t idx) {
        auto add = trunc(ids_in, n);
        auto& buf = stream_buf[idx];
        buf.insert(buf.end(), add.begin(), add.end());
        int keep = final ? 1 : branch_length;
        if ((int)buf.size() > keep) {
            for (int i = 0; i < (int)buf.size() - keep; ++i) {
                if (stop_words.count(buf[i])) continue;
                int m = std::min((int)buf.size() - (i + 1), branch_length);
                tree(buf[i])->put(&buf[i + 1], m, /*out*/ 0, idx);
                touched.insert(buf[i]);
            }
            if (!final)
                buf.assign(buf.end() - branch_length, buf.end());
        }
        if (final) {
            buf.clear();
            finalize(idx);
        }
    }

    int hier_get(const int32_t* q, int qn, int decoding_length,
                 int branch_length, int min_input_size, int min_output_size,
                 int mode, int32_t idx, int32_t* out_ids, uint8_t* out_mask,
                 int32_t* out_parents, int32_t* out_sizes) {
        out_sizes[0] = out_sizes[1] = 0;
        if (decoding_length <= 1 || branch_length == 0 || qn == 0) {
            if (qn == 0) return 0;
            out_ids[0] = q[qn - 1];
            out_mask[0] = 1;
            out_parents[0] = -1;
            return 1;
        }
        int best_n = 0;
        for (int i = 0; i < qn; ++i) {
            auto it = mem.find(q[i]);
            if (it == mem.end()) continue;
            int sufn = qn - (i + 1);
            if (stop_words.count(q[i]) && sufn == 0) continue;
            best_n = it->second->get(q + i + 1, sufn, decoding_length,
                                     branch_length, min_input_size,
                                     min_output_size, 1e-4, mode, idx, out_ids,
                                     out_mask, out_parents, out_sizes);
            if (best_n >= branch_length) return best_n;
        }
        if (best_n == 0) {
            out_ids[0] = q[qn - 1];
            out_mask[0] = 1;
            out_parents[0] = -1;
            return 1;
        }
        return best_n;
    }

    int one_get(const int32_t* q, int qn, int decoding_length,
                int branch_length, int mode, int32_t idx, int32_t* out_ids,
                uint8_t* out_mask, int32_t* out_parents, int32_t* out_sizes) {
        out_sizes[0] = out_sizes[1] = 0;
        if (decoding_length <= 1 || branch_length == 0 || qn == 0) {
            if (qn == 0) return 0;
            out_ids[0] = q[qn - 1];
            out_mask[0] = 1;
            out_parents[0] = -1;
            return 1;
        }
        int best_n = 0;
        for (int i = 0; i < qn; ++i) {
            auto it = mem.find(q[i]);
            if (it == mem.end()) continue;
            int sufn = qn - (i + 1);
            if (stop_words.count(q[i]) && sufn == 0) continue;
            best_n = it->second->get_one_branch(q + i + 1, sufn, branch_length,
                                                mode, idx, out_ids, out_mask,
                                                out_parents, out_sizes);
            if (best_n >= std::max(branch_length / 2, 1)) return best_n;
        }
        if (best_n == 0) {
            out_ids[0] = q[qn - 1];
            out_mask[0] = 1;
            out_parents[0] = -1;
            return 1;
        }
        return best_n;
    }
};

}  // namespace

extern "C" {

void* pia_cache_new(const int32_t* eos, int n_eos, int64_t max_node,
                    int64_t max_output_node, int64_t squeeze_every) {
    return new Cache(eos, n_eos, max_node, max_output_node, squeeze_every);
}

void pia_cache_free(void* c) { delete static_cast<Cache*>(c); }

void pia_cache_add_stop_word(void* c, int32_t tok) {
    static_cast<Cache*>(c)->stop_words.insert(tok);
}

void pia_cache_put(void* c, const int32_t* ids, int n, int branch_length,
                   int final, int mode, int32_t idx) {
    static_cast<Cache*>(c)->put(ids, n, branch_length, final, mode, idx);
}

void pia_cache_stream_put(void* c, const int32_t* ids, int n,
                          int branch_length, int final, int32_t idx) {
    static_cast<Cache*>(c)->stream_put(ids, n, branch_length, final, idx);
}

int pia_cache_hier_get(void* c, const int32_t* q, int qn, int decoding_length,
                       int branch_length, int min_input_size,
                       int min_output_size, int mode, int32_t idx,
                       int32_t* out_ids, uint8_t* out_mask,
                       int32_t* out_parents, int32_t* out_sizes) {
    return static_cast<Cache*>(c)->hier_get(
        q, qn, decoding_length, branch_length, min_input_size, min_output_size,
        mode, idx, out_ids, out_mask, out_parents, out_sizes);
}

int pia_cache_one_get(void* c, const int32_t* q, int qn, int decoding_length,
                      int branch_length, int mode, int32_t idx,
                      int32_t* out_ids, uint8_t* out_mask,
                      int32_t* out_parents, int32_t* out_sizes) {
    return static_cast<Cache*>(c)->one_get(q, qn, decoding_length,
                                           branch_length, mode, idx, out_ids,
                                           out_mask, out_parents, out_sizes);
}

int64_t pia_cache_n_tries(void* c) {
    return (int64_t)static_cast<Cache*>(c)->mem.size();
}

// ---- persistence (python DraftCache save_mem/load_mem capability parity;
// reference lookahead_cache.py:578). Binary format, version-tagged. ----

namespace {

void save_children(std::FILE* f, const std::unordered_map<int32_t, Node*>& kids,
                   const std::vector<int32_t>& order) {
    int32_t n = (int32_t)order.size();
    std::fwrite(&n, sizeof(n), 1, f);
    for (int32_t tok : order) {
        Node* nd = kids.at(tok);
        std::fwrite(&tok, sizeof(tok), 1, f);
        std::fwrite(&nd->out_freq, sizeof(double), 1, f);
        int32_t ni = (int32_t)nd->in_freqs.size();
        std::fwrite(&ni, sizeof(ni), 1, f);
        for (auto& kv : nd->in_freqs) {
            std::fwrite(&kv.first, sizeof(int32_t), 1, f);
            std::fwrite(&kv.second, sizeof(double), 1, f);
        }
        save_children(f, nd->kids, nd->kid_order);
    }
}

bool load_children(std::FILE* f, std::unordered_map<int32_t, Node*>& kids,
                   std::vector<int32_t>& order) {
    int32_t n;
    if (std::fread(&n, sizeof(n), 1, f) != 1) return false;
    order.reserve(n);
    for (int32_t i = 0; i < n; ++i) {
        int32_t tok, ni;
        auto* nd = new Node();
        if (std::fread(&tok, sizeof(tok), 1, f) != 1 ||
            std::fread(&nd->out_freq, sizeof(double), 1, f) != 1 ||
            std::fread(&ni, sizeof(ni), 1, f) != 1) {
            delete nd;
            return false;
        }
        for (int32_t j = 0; j < ni; ++j) {
            int32_t idx;
            double fr;
            if (std::fread(&idx, sizeof(idx), 1, f) != 1 ||
                std::fread(&fr, sizeof(fr), 1, f) != 1) {
                delete nd;
                return false;
            }
            nd->in_freqs[idx] = fr;
        }
        kids[tok] = nd;
        order.push_back(tok);
        if (!load_children(f, nd->kids, nd->kid_order)) return false;
    }
    return true;
}

constexpr char kMagic[8] = {'P', 'I', 'A', 'T', 'R', 'I', 'E', '1'};

}  // namespace

int pia_cache_save(void* c, const char* path) {
    auto* cache = static_cast<Cache*>(c);
    std::FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    std::fwrite(kMagic, 1, 8, f);
    int32_t nt = (int32_t)cache->mem.size();
    std::fwrite(&nt, sizeof(nt), 1, f);
    for (auto& kv : cache->mem) {
        TokenTrie* t = kv.second;
        std::fwrite(&t->token_id, sizeof(int32_t), 1, f);
        std::fwrite(&t->n_node, sizeof(int64_t), 1, f);
        std::fwrite(&t->n_output_node, sizeof(int64_t), 1, f);
        save_children(f, t->root, t->root_order_);
    }
    std::fclose(f);
    return 0;
}

int pia_cache_load(void* c, const char* path) {
    auto* cache = static_cast<Cache*>(c);
    std::FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    char magic[8];
    int32_t nt;
    if (std::fread(magic, 1, 8, f) != 8 ||
        std::memcmp(magic, kMagic, 8) != 0 ||
        std::fread(&nt, sizeof(nt), 1, f) != 1) {
        std::fclose(f);
        return -2;
    }
    for (auto& kv : cache->mem) delete kv.second;
    cache->mem.clear();
    for (int32_t i = 0; i < nt; ++i) {
        int32_t tid;
        if (std::fread(&tid, sizeof(tid), 1, f) != 1) {
            std::fclose(f);
            return -3;
        }
        auto* t = new TokenTrie(tid, cache->max_node, cache->max_output_node);
        if (std::fread(&t->n_node, sizeof(int64_t), 1, f) != 1 ||
            std::fread(&t->n_output_node, sizeof(int64_t), 1, f) != 1 ||
            !load_children(f, t->root, t->root_order_)) {
            delete t;
            std::fclose(f);
            return -3;
        }
        cache->mem[tid] = t;
    }
    std::fclose(f);
    return 0;
}

void pia_cache_fresh(void* c) {
    auto* cache = static_cast<Cache*>(c);
    for (auto& kv : cache->mem) delete kv.second;
    cache->mem.clear();
    cache->stream_buf.clear();
    cache->touched.clear();
    cache->touched_input.clear();
}
}
