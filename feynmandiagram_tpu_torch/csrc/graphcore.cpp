// graphcore: native kernels for the host-side IR pipeline.
//
// Operates on the flattened record arrays produced by the Python lowering
// (ops, power exponents, property keys, CSR edges) and provides the two
// passes that dominate host time on 1e5..1e7-node DAGs:
//
//   fd_cse    structural hash-consing (common-subexpression elimination):
//             maps every node to a canonical representative; children are
//             compared as factor-weighted multisets (commutative Sum/Prod),
//             matching the Python optimizer's equivalence relation
//   fd_depth  topological depth (level) computation
//
// Exposed with a plain C ABI for ctypes.
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>
#include <algorithm>

namespace {

struct KeyHash {
    size_t operator()(const std::vector<uint64_t>& v) const {
        uint64_t h = 1469598103934665603ull;  // FNV-1a
        for (uint64_t x : v) {
            h ^= x;
            h *= 1099511628211ull;
        }
        return static_cast<size_t>(h);
    }
};

inline uint64_t bits_of(double d) {
    uint64_t u;
    std::memcpy(&u, &d, sizeof(u));
    return u;
}

}  // namespace

extern "C" {

// Structural CSE over a topologically-ordered record table.
//
// ops[i]:    0 = leaf, 1 = sum, 2 = prod, 3 = power, 4 = const
// powers[i]: exponent for power nodes (0 otherwise)
// prop[i]:   64-bit property key (hash of DiagramId/orders for leaves;
//            0 when absent).  Two nodes can only merge if keys match.
// edges:     CSR child lists: edge_ptr[i]..edge_ptr[i+1] index into
//            edge_src / edge_fac
// remap:     out, length n — canonical node index for every node
//
// Returns the number of canonical nodes.
int64_t fd_cse(int64_t n,
               const int8_t* ops,
               const int32_t* powers,
               const uint64_t* prop,
               const int64_t* edge_ptr,
               const int64_t* edge_src,
               const double* edge_fac,
               int64_t* remap) {
    std::unordered_map<std::vector<uint64_t>, int64_t, KeyHash> canon;
    canon.reserve(static_cast<size_t>(n) * 2);
    std::vector<uint64_t> key;
    std::vector<std::pair<uint64_t, uint64_t>> kids;
    int64_t n_canon = 0;

    for (int64_t i = 0; i < n; ++i) {
        key.clear();
        key.push_back(static_cast<uint64_t>(ops[i]));
        key.push_back(static_cast<uint64_t>(powers[i]));
        key.push_back(prop[i]);
        kids.clear();
        for (int64_t e = edge_ptr[i]; e < edge_ptr[i + 1]; ++e) {
            kids.emplace_back(static_cast<uint64_t>(remap[edge_src[e]]),
                              bits_of(edge_fac[e]));
        }
        // commutative multiset ordering for Sum/Prod (and trivially for
        // single-child Power)
        std::sort(kids.begin(), kids.end());
        for (auto& kv : kids) {
            key.push_back(kv.first);
            key.push_back(kv.second);
        }
        auto it = canon.find(key);
        if (it == canon.end()) {
            canon.emplace(key, i);
            remap[i] = i;
            ++n_canon;
        } else {
            remap[i] = it->second;
        }
    }
    return n_canon;
}

// Topological depth: depth[i] = 0 for childless nodes, else 1 + max child.
// Assumes edge_src[e] < i is NOT required — records must simply be in an
// order where children precede parents (postorder), which the lowering
// guarantees.
void fd_depth(int64_t n,
              const int64_t* edge_ptr,
              const int64_t* edge_src,
              int32_t* depth) {
    for (int64_t i = 0; i < n; ++i) {
        int32_t d = 0;
        for (int64_t e = edge_ptr[i]; e < edge_ptr[i + 1]; ++e) {
            int32_t cd = depth[edge_src[e]] + 1;
            if (cd > d) d = cd;
        }
        depth[i] = d;
    }
}

}  // extern "C"
