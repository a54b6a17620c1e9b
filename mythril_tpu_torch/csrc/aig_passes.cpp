// Host-side cone passes of the AIG rewrite (preanalysis/aig_opt.py) and of
// its partition (preanalysis/aig_partition.py), bound through a plain C ABI
// with ctypes (g++ builds this file into the port's host library with
// native/sat.cpp, smt/solver/sat_backend.py; preanalysis/aig_native.py
// calls it).
//
//   aig_source_pass      the source side of one rewrite: the cone of the
//                        roots in ascending var order, the node cap, the
//                        forced constants of the root sweep (or the
//                        contradiction that makes the result trivially
//                        UNSAT), the liveness of the rebuilt structure, and
//                        for each cone var what the rebuild does with it.
//   aig_cone_components  the rewritten side: the gates in the cone of the
//                        new roots and, for each root, its variable-disjoint
//                        component, named by the component's smallest var.
//
// Both cost O(cone), never O(AIG): the AIGs they walk are shared (the
// global blaster's holds every query ever blasted, the rewrite session's
// every sibling's rewrite). Per-var scratch is stamped with an epoch and
// kept per thread across calls, so a call touches only the vars it visits.
// Each pass reproduces the JAX package's Python passes
// (mythril_tpu/preanalysis/aig_opt.py, aig_partition.py) exactly, down to
// the order the root sweep forces constants in
// (tests/test_torch_aig_native.py holds the two equal).

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

// what the rebuild does with one cone var (aig_opt.py names the same codes)
enum Kind : int8_t {
  kSkip = 0,          // dead fanout: pruned
  kPinnedTrue = 1,    // forced input: a session var pinned by a unit root
  kPinnedFalse = 2,
  kForcedFalse = 3,   // asserted-false gate: rebuilt, its negation a root
  kForcedTrue = 4,    // decomposed gate: the constant TRUE at its uses
  kInput = 5,         // live free input
  kImpure = 6,        // live gate with a forced var in its fanin cone
  kPure = 7,          // live gate whose fanin cone is free of forced vars
};

enum Status : int64_t { kOk = 0, kOverCap = 1, kContradiction = 2 };

struct Scratch {
  std::vector<uint32_t> stamp;  // var visited in this call iff == epoch
  std::vector<int32_t> slot;    // source: cone index; rewritten: uf parent
  std::vector<int8_t> forced;   // source: -1 free, 0 false, 1 true
  std::vector<int32_t> stack;
  std::vector<int32_t> cone;
  std::vector<uint8_t> flags;   // per cone index: live, clean
  uint32_t epoch = 0;

  // a new epoch over vars [0, n); vectors grow by doubling, so a growing
  // AIG costs amortised O(1) a var
  void begin(int64_t n) {
    if ((int64_t)stamp.size() < n) {
      size_t size = std::max<size_t>((size_t)n, 2 * stamp.size());
      stamp.resize(size, 0);
      slot.resize(size);
      forced.resize(size);
    }
    if (++epoch == 0) {
      std::fill(stamp.begin(), stamp.end(), 0);
      epoch = 1;
    }
    stack.clear();
    cone.clear();
  }

  bool visit(int32_t var) {
    if (stamp[var] == epoch) return false;
    stamp[var] = epoch;
    return true;
  }
};

thread_local Scratch scratch;

constexpr uint8_t kLive = 1, kClean = 2;

inline int32_t find(std::vector<int32_t>& parent, int32_t var) {
  while (parent[var] != var) {
    parent[var] = parent[parent[var]];  // path halving
    var = parent[var];
  }
  return var;
}

}  // namespace

extern "C" {

// The source side of optimize_roots over the gate table lhs/rhs (per var
// its gate's input literals, -1 for inputs and var 0). `roots` are the live
// root literals (no constants). When the cone exceeds `cap` vars, meta[0]
// is kOverCap and nothing else is written. Otherwise cone_out[0:count] is
// the cone in ascending var order (cone_out holds min(cap, num_vars)) and
// kind_out[i] what the rebuild does with cone_out[i]. meta: status, count,
// gates (nodes_before), forced vars, forced inputs, const folds at a
// contradiction (kContradiction: the forced count then plus one).
void aig_source_pass(int num_vars, const int32_t* lhs, const int32_t* rhs,
                     const int32_t* roots, int num_roots, int force_roots,
                     int cap, int32_t* cone_out, int8_t* kind_out,
                     int64_t* meta) {
  Scratch& s = scratch;
  s.begin((int64_t)num_vars + 1);
  for (int i = 0; i < 6; ++i) meta[i] = 0;

  // cone of influence
  for (int i = 0; i < num_roots; ++i) {
    int32_t var = roots[i] >> 1;
    if (var != 0 && s.visit(var)) s.stack.push_back(var);
  }
  while (!s.stack.empty()) {
    int32_t var = s.stack.back();
    s.stack.pop_back();
    if ((int64_t)s.cone.size() == cap) {
      meta[0] = kOverCap;
      return;
    }
    s.cone.push_back(var);
    int32_t a = lhs[var];
    if (a < 0) continue;
    int32_t av = a >> 1, bv = rhs[var] >> 1;
    if (av != 0 && s.visit(av)) s.stack.push_back(av);
    if (bv != 0 && s.visit(bv)) s.stack.push_back(bv);
  }
  std::sort(s.cone.begin(), s.cone.end());
  const int64_t count = (int64_t)s.cone.size();
  int64_t gates = 0;
  for (int64_t i = 0; i < count; ++i) {
    int32_t var = s.cone[i];
    s.slot[var] = (int32_t)i;
    s.forced[var] = -1;
    cone_out[i] = var;
    gates += lhs[var] >= 0;
  }
  meta[1] = count;
  meta[2] = gates;

  // the root sweep: forced-TRUE AND gates decompose into forced fanins, in
  // the reference sweep's order (a stack seeded with the roots), so that a
  // contradiction is found with the same number of constants forced
  int64_t n_forced = 0, n_pinned = 0;
  if (force_roots) {
    for (int i = 0; i < num_roots; ++i) s.stack.push_back(roots[i]);
    while (!s.stack.empty()) {
      int32_t lit = s.stack.back();
      s.stack.pop_back();
      if (lit == 1) continue;  // TRUE
      if (lit == 0) {          // FALSE
        meta[0] = kContradiction;
        meta[5] = n_forced + 1;
        return;
      }
      int32_t var = lit >> 1;
      int8_t value = (lit & 1) ? 0 : 1;
      int8_t known = s.forced[var];
      if (known >= 0) {
        if (known != value) {
          meta[0] = kContradiction;
          meta[5] = n_forced + 1;
          return;
        }
        continue;
      }
      s.forced[var] = value;
      ++n_forced;
      if (lhs[var] < 0) {
        ++n_pinned;
      } else if (value) {
        s.stack.push_back(lhs[var]);
        s.stack.push_back(rhs[var]);
      }
    }
  }
  meta[3] = n_forced;
  meta[4] = n_pinned;

  // liveness, backward: only structure reachable from the gates that stay
  // asserted (forced-FALSE gates) is rebuilt; without forcing the whole
  // cone stays asserted
  s.flags.assign((size_t)count, force_roots ? 0 : kLive);
  if (force_roots) {
    for (int64_t i = count - 1; i >= 0; --i) {
      int32_t var = s.cone[i];
      if (lhs[var] < 0) continue;
      if (!(s.flags[i] & kLive) && s.forced[var] != 0) continue;
      s.flags[i] |= kLive;
      for (int32_t child : {lhs[var] >> 1, rhs[var] >> 1}) {
        if (child != 0 && s.forced[child] < 0) s.flags[s.slot[child]] |= kLive;
      }
    }
  }

  // forward: a var is clean when no var in its fanin cone (itself
  // included) is forced; the kind of each cone var
  for (int64_t i = 0; i < count; ++i) {
    int32_t var = s.cone[i];
    bool gate = lhs[var] >= 0;
    int8_t value = s.forced[var];
    int8_t kind;
    if (value >= 0) {
      kind = gate ? (value ? kForcedTrue : kForcedFalse)
                  : (value ? kPinnedTrue : kPinnedFalse);
    } else {
      bool clean = true;
      if (gate) {
        for (int32_t child : {lhs[var] >> 1, rhs[var] >> 1}) {
          if (child != 0 && !(s.flags[s.slot[child]] & kClean)) clean = false;
        }
      }
      if (clean) s.flags[i] |= kClean;
      if (!(s.flags[i] & kLive)) {
        kind = kSkip;
      } else if (!gate) {
        kind = kInput;
      } else {
        kind = clean ? kPure : kImpure;
      }
    }
    kind_out[i] = kind;
  }
}

// Gates in the cone of `roots` over the gate table lhs/rhs (the return
// value), and for each root the smallest var of its variable-disjoint
// component in that cone (root_rep[i]; 0 for a constant root). Two vars
// share a component when a chain of gate-fanin edges joins them; constant
// fanins join nothing. Ordering components by their smallest var is the
// order scipy's connected_components labels them in over the sorted cone.
int64_t aig_cone_components(int num_vars, const int32_t* lhs,
                            const int32_t* rhs, const int32_t* roots,
                            int num_roots, int32_t* root_rep) {
  Scratch& s = scratch;
  s.begin((int64_t)num_vars + 1);
  std::vector<int32_t>& parent = s.slot;
  for (int i = 0; i < num_roots; ++i) {
    int32_t var = roots[i] >> 1;
    if (var != 0 && s.visit(var)) {
      parent[var] = var;
      s.stack.push_back(var);
    }
  }
  int64_t gates = 0;
  while (!s.stack.empty()) {
    int32_t var = s.stack.back();
    s.stack.pop_back();
    if (lhs[var] < 0) continue;
    ++gates;
    for (int32_t child : {lhs[var] >> 1, rhs[var] >> 1}) {
      if (child == 0) continue;
      if (s.visit(child)) {
        parent[child] = child;
        s.stack.push_back(child);
      }
      // union, the smaller var the new root: a tree's root stays the
      // smallest var in it
      int32_t a = find(parent, var), b = find(parent, child);
      if (a < b) {
        parent[b] = a;
      } else if (b < a) {
        parent[a] = b;
      }
    }
  }
  for (int i = 0; i < num_roots; ++i) {
    int32_t var = roots[i] >> 1;
    root_rep[i] = var == 0 ? 0 : find(parent, var);
  }
  return gates;
}

}  // extern "C"
