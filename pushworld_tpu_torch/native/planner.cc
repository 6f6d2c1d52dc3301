// Native serial PushWorld planner.
//
// The CPU-side runtime component of pushworld-tpu: a greedy best-first
// search with novelty + fewest-tools recursive-graph-distance heuristics,
// semantically equivalent to the reference C++ planner
// (reference: cpp/src/run_planner.cc, cpp/src/heuristics/*.cc,
// cpp/include/search/best_first_search.h) but architected differently:
//
//  - no Boost: flat arrays, FNV hashing, open-addressing visited table;
//  - node arena (contiguous positions + parent/action records) instead of
//    shared_ptr chains; plans backtrack stored actions, no re-simulation;
//  - two-level bucket priority queue (novelty tier x integer RGD value,
//    LIFO within a bucket) instead of a Fibonacci heap;
//  - consumes the dense collision tables produced by
//    pushworld_tpu.core.compiled (the same tensors the TPU kernels use),
//    compacted to per-pair contact-offset lists at load.
//
// Exposed as a small C API used via ctypes (pushworld_tpu/native/bridge.py).

#include <chrono>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();
constexpr int kNumActions = 4;
const int kDx[4] = {-1, 1, 0, 0};
const int kDy[4] = {0, 0, -1, 1};
using Clock = std::chrono::steady_clock;

struct Contact {
  int16_t rx;
  int16_t ry;
};

// ----------------------------------------------------------------- puzzle

struct Puzzle {
  int n = 0;        // movables (agent first)
  int H = 0, W = 0; // grid incl. border
  int HW = 0;
  int num_goals = 0;
  std::vector<int32_t> goal_pos;             // packed, per goal object k -> index k+1
  std::vector<int32_t> init_state;           // packed positions, n entries
  std::vector<uint8_t> static_block;         // [a][o][p] -> 4*n*HW
  // Contact offsets per (action, pusher, pushee): pusher at pushee + rel.
  std::vector<std::vector<Contact>> contacts; // index a*n*n + q*n + o

  inline bool blocked(int a, int o, int p) const {
    return static_block[(a * n + o) * HW + p] != 0;
  }
  inline const std::vector<Contact>& contact(int a, int q, int o) const {
    return contacts[(a * n + q) * n + o];
  }
};

// ------------------------------------------------------------- transition

// Returns true and fills next if something moved; false otherwise.
// Semantics: reference pushworld_puzzle.cc:386-460 (transitive stopping).
bool step(const Puzzle& pz, const int32_t* state, int action, int32_t* next,
          uint32_t* moved_mask) {
  const int n = pz.n;
  const int W = pz.W;
  if (pz.blocked(action, 0, state[0])) return false;

  uint32_t pushed = 1u; // bit per movable; agent always moves
  int frontier[32];
  int fsize = 0;
  frontier[fsize++] = 0;
  while (fsize) {
    const int i = frontier[--fsize];
    const int xi = state[i] % W;
    const int yi = state[i] / W;
    for (int j = 1; j < n; j++) {
      if (pushed & (1u << j)) continue;
      const int rx = xi - state[j] % W;
      const int ry = yi - state[j] / W;
      bool hit = false;
      for (const Contact& c : pz.contact(action, i, j)) {
        if (c.rx == rx && c.ry == ry) { hit = true; break; }
      }
      if (!hit) continue;
      if (pz.blocked(action, j, state[j])) return false; // transitive stop
      pushed |= (1u << j);
      frontier[fsize++] = j;
    }
  }
  const int disp = kDy[action] * W + kDx[action];
  for (int i = 0; i < n; i++) {
    next[i] = (pushed & (1u << i)) ? state[i] + disp : state[i];
  }
  *moved_mask = pushed;
  return true;
}

// ------------------------------------------------- feasible movement graph

// E[a][o] bitsets over positions: transition (o at p -> p+d_a) feasible.
// Semantics: reference domain_transition_graph.cc:113-216 (worklist fixpoint).
struct MovementGraphs {
  int n, HW, W;
  std::vector<std::vector<uint8_t>> E; // [a*n+o] -> HW bytes

  inline bool edge(int a, int o, int p) const { return E[a * n + o][p] != 0; }
};

MovementGraphs build_graphs(const Puzzle& pz) {
  MovementGraphs g;
  g.n = pz.n;
  g.HW = pz.HW;
  g.W = pz.W;
  g.E.assign(kNumActions * pz.n, std::vector<uint8_t>(pz.HW, 0));
  std::vector<std::vector<uint8_t>> reached(pz.n,
                                            std::vector<uint8_t>(pz.HW, 0));
  // Reverse contact lists: for pusher transition (q, p, a), which pushee
  // transitions may it enable?  pushee at p - rel.
  struct Dep { int o; int16_t rx, ry; };
  std::vector<std::vector<Dep>> deps(kNumActions * pz.n);
  for (int a = 0; a < kNumActions; a++)
    for (int q = 0; q < pz.n; q++)
      for (int o = 1; o < pz.n; o++) {
        if (q == o) continue;
        for (const Contact& c : pz.contact(a, q, o))
          deps[a * pz.n + q].push_back({o, c.rx, c.ry});
      }

  struct Ev { int kind; int o; int p; int a; }; // kind 0 = pos, 1 = edge
  std::vector<Ev> work;
  for (int i = 0; i < pz.n; i++) {
    reached[i][pz.init_state[i]] = 1;
    work.push_back({0, i, pz.init_state[i], 0});
  }

  auto has_pusher = [&](int o, int a, int p) {
    const int x = p % pz.W, y = p / pz.W;
    for (int q = 0; q < pz.n; q++) {
      if (q == o) continue;
      for (const Contact& c : pz.contact(a, q, o)) {
        const int sx = x + c.rx, sy = y + c.ry;
        if (sx < 0 || sx >= pz.W || sy < 0 || sy >= pz.H) continue;
        if (g.edge(a, q, sy * pz.W + sx)) return true;
      }
    }
    return false;
  };

  auto add_edge = [&](int o, int p, int a) {
    auto& row = g.E[a * pz.n + o];
    if (row[p]) return;
    row[p] = 1;
    work.push_back({1, o, p, a});
    const int np = p + kDy[a] * pz.W + kDx[a];
    if (!reached[o][np]) {
      reached[o][np] = 1;
      work.push_back({0, o, np, 0});
    }
  };

  while (!work.empty()) {
    const Ev ev = work.back();
    work.pop_back();
    if (ev.kind == 0) {
      for (int a = 0; a < kNumActions; a++) {
        if (pz.blocked(a, ev.o, ev.p)) continue;
        if (ev.o == 0 || has_pusher(ev.o, a, ev.p)) add_edge(ev.o, ev.p, a);
      }
    } else {
      // New pusher edge may enable pushee transitions.
      const int x = ev.p % pz.W, y = ev.p / pz.W;
      for (const Dep& d : deps[ev.a * pz.n + ev.o]) {
        const int px = x - d.rx, py = y - d.ry;
        if (px < 0 || px >= pz.W || py < 0 || py >= pz.H) continue;
        const int pp = py * pz.W + px;
        if (reached[d.o][pp] && !pz.blocked(ev.a, d.o, pp))
          add_edge(d.o, pp, ev.a);
      }
    }
  }
  return g;
}

// --------------------------------------------------------------- distances

// Lazy per-target BFS distance fields over reversed edges.
// Semantics: reference domain_transition_graph.cc:218-300.
struct Distances {
  const MovementGraphs* g;
  int o;
  std::unordered_map<int, std::vector<float>> fields; // target -> dist[p]

  const std::vector<float>& field(int target) {
    auto it = fields.find(target);
    if (it != fields.end()) return it->second;
    std::vector<float> d(g->HW, kInf);
    d[target] = 0.f;
    std::vector<int> frontier{target}, next;
    float depth = 0.f;
    while (!frontier.empty()) {
      depth += 1.f;
      next.clear();
      for (int t : frontier) {
        const int x = t % g->W, y = t / g->W;
        // predecessors p with edge p -> t: p = t - d_a and E[a][o][p].
        for (int a = 0; a < kNumActions; a++) {
          const int px = x - kDx[a], py = y - kDy[a];
          if (px < 0 || px >= g->W || py < 0) continue;
          const int p = py * g->W + px;
          if (p >= g->HW) continue;
          if (g->edge(a, o, p) && d[p] == kInf) {
            d[p] = depth;
            next.push_back(p);
          }
        }
      }
      frontier.swap(next);
    }
    return fields.emplace(target, std::move(d)).first->second;
  }

  inline float dist(int source, int target) { return field(target)[source]; }
};

// --------------------------------------------------------------------- RGD

// Semantics: reference recursive_graph_distance.cc:43-252 (fewest tools).
struct RGD {
  const Puzzle* pz;
  MovementGraphs graphs;
  std::vector<Distances> dists;

  struct PCKey {
    int32_t q, qp, o, s, e;
    bool operator==(const PCKey& k) const {
      return q == k.q && qp == k.qp && o == k.o && s == k.s && e == k.e;
    }
  };
  struct PCKeyHash {
    size_t operator()(const PCKey& k) const {
      uint64_t h = 1469598103934665603ull;
      const int32_t v[5] = {k.q, k.qp, k.o, k.s, k.e};
      for (int32_t x : v) { h ^= (uint64_t)(uint32_t)x; h *= 1099511628211ull; }
      return (size_t)h;
    }
  };
  // costs: pusher_next_position -> min distance cost.
  std::unordered_map<PCKey, std::vector<std::pair<int, float>>, PCKeyHash>
      pc_cache;

  // Budget enforcement INSIDE the recursion: a single fewest-tools
  // estimate on a many-movable state with an unreachable goal explodes
  // combinatorially (the depth loop reaches n-2 and the skip-set
  // branching is uncached), and the search loop's every-256-expansions
  // deadline check never runs during it — measured 500+ s on a 60 s
  // budget (level2/Pinata) before this guard.  The reference planner has
  // the identical structure and the identical pathology
  // (recursive_graph_distance.cc:101-174); aborting mid-estimate only
  // ends the attempt with budget-exhausted, never changes a returned
  // plan.
  Clock::time_point deadline{};
  bool has_deadline = false;
  const volatile int32_t* cancel = nullptr;
  int64_t probes = 0;
  bool expired = false;
  bool cancelled = false;

  inline bool out_of_budget() {
    if (expired) return true;
    if ((++probes & 0xFFF) == 0) {
      if (cancel && *cancel) { expired = cancelled = true; return true; }
      if (has_deadline && Clock::now() > deadline) { expired = true; return true; }
    }
    return false;
  }

  explicit RGD(const Puzzle& p) : pz(&p), graphs(build_graphs(p)) {
    dists.reserve(p.n);
    for (int o = 0; o < p.n; o++) dists.push_back(Distances{&graphs, o, {}});
  }

  const std::vector<std::pair<int, float>>& pushing_costs(
      int q, int qp, int o, int s, int e) {
    PCKey key{q, qp, o, s, e};
    auto it = pc_cache.find(key);
    if (it != pc_cache.end()) return it->second;

    std::vector<std::pair<int, float>> costs;
    const int d = e - s;
    int action = -1;
    for (int a = 0; a < kNumActions; a++)
      if (kDy[a] * pz->W + kDx[a] == d) { action = a; break; }
    const int sx = s % pz->W, sy = s / pz->W;

    // Pusher next positions from qp.
    int nexts[4];
    int n_next = 0;
    for (int a = 0; a < kNumActions; a++)
      if (graphs.edge(a, q, qp))
        nexts[n_next++] = qp + kDy[a] * pz->W + kDx[a];

    for (const Contact& c : pz->contact(action, q, o)) {
      const int cx = sx + c.rx, cy = sy + c.ry;
      if (cx < 0 || cx >= pz->W || cy < 0 || cy >= pz->H) continue;
      const int contact = cy * pz->W + cx;
      if (!graphs.edge(action, q, contact)) continue;
      const int contact_end = contact + d;
      for (int k = 0; k < n_next; k++) {
        const int pn = nexts[k];
        float cost;
        if (contact == qp && contact_end == pn) {
          cost = 0.f; // simultaneous push
        } else {
          const float dc = dists[q].dist(pn, contact);
          if (dc == kInf) continue;
          cost = dc + 1.f;
        }
        bool found = false;
        for (auto& pr : costs)
          if (pr.first == pn) { found = true; if (cost < pr.second) pr.second = cost; break; }
        if (!found) costs.emplace_back(pn, cost);
      }
    }
    return pc_cache.emplace(key, std::move(costs)).first->second;
  }

  // ``agent_pn`` (optional) receives the agent's next position on the
  // winning (argmin) branch — the first physical move of the cheapest
  // tool chain the heuristic found.  The search layer turns it into a
  // PREFERRED ACTION (classic helpful-action/preferred-operator pruning:
  // the recursion already identifies the pusher path, so expanding its
  // one implied action first focuses greedy descent; cf. reference
  // recursive_graph_distance.cc:114-174, which computes the same argmin
  // chain but discards it).
  float recursive_pushing_cost(const int32_t* state, int o, int cur, int eff,
                               uint32_t skipped, int depth, float bound,
                               int* agent_pn = nullptr) {
    float min_cost = bound;
    if (out_of_budget()) return min_cost;
    skipped |= (1u << o);
    const int start = depth == 0 ? 0 : 1;
    const int end = depth == 0 ? 1 : pz->n;
    for (int q = start; q < end; q++) {
      if (skipped & (1u << q)) continue;
      const auto& pcs = pushing_costs(q, state[q], o, cur, eff);
      for (const auto& [pn, dist_cost] : pcs) {
        if (dist_cost >= min_cost) continue;
        if (q == 0) {
          const float total = dist_cost + 1.f;
          if (total < min_cost) {
            min_cost = total;
            if (agent_pn) *agent_pn = pn;
          }
        } else {
          int sub_pn = -1;
          const float sub = recursive_pushing_cost(
              state, q, state[q], pn, skipped, depth - 1,
              min_cost - dist_cost, agent_pn ? &sub_pn : nullptr);
          const float total = dist_cost + sub;
          if (total < min_cost) {
            min_cost = total;
            if (agent_pn) *agent_pn = sub_pn;
          }
        }
      }
    }
    return min_cost;
  }

  float goal_cost(const int32_t* state, int o, int goal, int depth,
                  int* agent_pn = nullptr) {
    const int cur = state[o];
    if (cur == goal) return 0.f;
    float min_cost = kInf;
    for (int a = 0; a < kNumActions; a++) {
      if (!graphs.edge(a, o, cur)) continue;
      const int eff = cur + kDy[a] * pz->W + kDx[a];
      const float gd = dists[o].dist(eff, goal);
      if (gd >= min_cost) continue;
      int sub_pn = -1;
      const float total =
          gd + recursive_pushing_cost(state, o, cur, eff, 0u, depth,
                                      min_cost - gd,
                                      agent_pn ? &sub_pn : nullptr);
      if (total < min_cost) {
        min_cost = total;
        if (agent_pn) *agent_pn = sub_pn;
      }
    }
    return min_cost;
  }

  // ``pref_action`` (optional) receives the action moving the agent onto
  // the winning branch's next position for the first unsatisfied goal
  // with a finite cost (-1 when no such action exists).
  float estimate(const int32_t* state, int* pref_action = nullptr) {
    if (pref_action) *pref_action = -1;
    float cost = 0.f;
    for (int k = 0; k < pz->num_goals; k++) {
      const int o = k + 1;
      float c = kInf;
      int agent_pn = -1;
      const bool want_pref =
          pref_action && *pref_action < 0 && state[o] != pz->goal_pos[k];
      for (int depth = 0; depth < pz->n - 1; depth++) {
        c = goal_cost(state, o, pz->goal_pos[k], depth,
                      want_pref ? &agent_pn : nullptr);
        if (c != kInf) break;
      }
      if (want_pref && agent_pn >= 0) {
        const int d = agent_pn - state[0];
        for (int a = 0; a < kNumActions; a++)
          if (kDy[a] * pz->W + kDx[a] == d) { *pref_action = a; break; }
      }
      cost += c;
      if (cost == kInf) break;
    }
    return cost;
  }
};

// ----------------------------------------------------------------- novelty

// Semantics: reference novelty.cc:30-77.
struct Novelty {
  int n;
  std::vector<std::unordered_set<int32_t>> seen_pos;
  std::unordered_map<uint64_t, std::unordered_set<uint64_t>> seen_pairs;

  explicit Novelty(int n_) : n(n_), seen_pos(n_) {}

  float estimate(const int32_t* state, uint32_t moved) {
    float novelty = 3.f;
    for (int i = 0; i < n; i++) {
      if (!(moved & (1u << i))) continue;
      if (seen_pos[i].insert(state[i]).second) novelty = 1.f;
      for (int j = 0; j < n; j++) {
        if (j == i) continue;
        const int lo = j < i ? j : i;
        const int hi = j < i ? i : j;
        const uint64_t pair_id = ((uint64_t)lo << 32) | (uint32_t)hi;
        const uint64_t pos_pair =
            ((uint64_t)(uint32_t)state[lo] << 32) | (uint32_t)state[hi];
        if (seen_pairs[pair_id].insert(pos_pair).second && novelty > 2.f)
          novelty = 2.f;
      }
    }
    return novelty;
  }
};

// ---------------------------------------------------------- visited + heap

struct Visited {
  std::vector<uint64_t> hashes;
  std::vector<int32_t> nodes; // node index per slot (-1 empty)
  uint64_t mask;
  size_t count = 0;
  const std::vector<int32_t>* arena;
  int n;

  Visited(size_t bits, const std::vector<int32_t>* arena_, int n_)
      : hashes(1ull << bits, 0),
        nodes(1ull << bits, -1),
        mask((1ull << bits) - 1),
        arena(arena_),
        n(n_) {}

  static uint64_t hash_state(const int32_t* s, int n) {
    uint64_t h = 1469598103934665603ull;
    for (int i = 0; i < n; i++) {
      h ^= (uint32_t)s[i];
      h *= 1099511628211ull;
      h ^= h >> 29;
    }
    return h ? h : 1;
  }

  size_t mem_bytes() const {
    return hashes.capacity() * sizeof(uint64_t) +
           nodes.capacity() * sizeof(int32_t);
  }

  // Doubles the table; a fixed-capacity open-addressing table would probe
  // forever once full (the search loop's deadline check never runs inside
  // insert), so growth is mandatory for long searches.
  void grow() {
    const size_t new_cap = (mask + 1) * 2;
    std::vector<uint64_t> old_hashes(new_cap, 0);
    std::vector<int32_t> old_nodes(new_cap, -1);
    old_hashes.swap(hashes);
    old_nodes.swap(nodes);
    mask = new_cap - 1;
    for (size_t i = 0; i < old_nodes.size(); i++) {
      if (old_nodes[i] < 0) continue;
      uint64_t slot = old_hashes[i] & mask;
      while (nodes[slot] >= 0) slot = (slot + 1) & mask;
      hashes[slot] = old_hashes[i];
      nodes[slot] = old_nodes[i];
    }
  }

  // Returns true if inserted (new); false if already present.
  bool insert(const int32_t* s, int32_t node_idx) {
    if (count * 2 >= mask + 1) grow();
    const uint64_t h = hash_state(s, n);
    uint64_t slot = h & mask;
    while (true) {
      if (nodes[slot] < 0) {
        hashes[slot] = h;
        nodes[slot] = node_idx;
        count++;
        return true;
      }
      if (hashes[slot] == h &&
          std::memcmp(arena->data() + (size_t)nodes[slot] * n, s,
                      n * sizeof(int32_t)) == 0)
        return false;
      slot = (slot + 1) & mask;
    }
  }
};

// Two-level bucket queue: novelty tier (0..2) x integer rgd value;
// infinite-rgd states go to an overflow tier popped last.  Within a bucket
// the discipline is LIFO (depth-first plateau descent; the reference's
// BucketPriorityQueue stacks, priority_queue.h:191-221) or FIFO
// (breadth-like plateau sweep, closer to its FibonacciPriorityQueue's
// behavior on ties) — greedy best-first outcomes are ordering-sensitive, so
// the staged portfolio runs both.  FIFO pops advance a head cursor instead
// of erasing (amortized O(1); memory is reclaimed when a bucket drains).
struct BucketQueue {
  struct Bucket {
    std::vector<int32_t> v;
    size_t head = 0;  // FIFO cursor
    bool empty() const { return head >= v.size(); }
  };
  std::vector<std::vector<Bucket>> tiers; // [tier][rgd] -> nodes
  Bucket overflow;
  size_t count = 0;
  bool fifo = false;

  explicit BucketQueue(bool fifo_order = false) : tiers(3), fifo(fifo_order) {}

  void push(int32_t node, float novelty, float rgd) {
    count++;
    if (rgd == kInf) { overflow.v.push_back(node); return; }
    const int tier = (int)novelty - 1;
    const size_t r = (size_t)rgd;
    auto& t = tiers[tier];
    if (t.size() <= r) t.resize(r + 1);
    t[r].v.push_back(node);
  }

  int32_t pop_bucket(Bucket& b) {
    int32_t v;
    if (fifo) {
      v = b.v[b.head++];
      if (b.empty()) { b.v.clear(); b.head = 0; }
    } else {
      v = b.v.back();
      b.v.pop_back();
    }
    count--;
    return v;
  }

  int32_t pop() {
    for (auto& tier : tiers)
      for (auto& bucket : tier)
        if (!bucket.empty()) return pop_bucket(bucket);
    return pop_bucket(overflow);
  }

  // Type-based exploration pop (cf. Xie et al. 2014's type buckets):
  // a uniformly random NONEMPTY bucket (not a uniformly random node —
  // deep plateaus hold most nodes, so uniform-over-buckets is what
  // actually diversifies), then a uniformly random element within it.
  // Greedy best-first stalls on heuristic plateaus; occasionally popping
  // an arbitrary depth/score stratum escapes them.
  int32_t pop_random(uint64_t* rng) {
    // Reservoir-sample a uniformly random NONEMPTY bucket in one pass —
    // no cap, so instances whose RGD values span many buckets sample every
    // stratum (a fixed-size candidate array would silently bias toward
    // low-novelty/low-h buckets and weaken the plateau escape).
    Bucket* chosen = nullptr;
    uint64_t seen = 0;
    auto consider = [&](Bucket& b) {
      if (b.empty()) return;
      seen++;
      *rng ^= *rng << 13; *rng ^= *rng >> 7; *rng ^= *rng << 17;
      if (*rng % seen == 0) chosen = &b;
    };
    for (auto& tier : tiers)
      for (auto& bucket : tier) consider(bucket);
    consider(overflow);
    if (chosen == nullptr) return pop();  // unreachable when count > 0
    Bucket& b = *chosen;
    *rng ^= *rng << 13; *rng ^= *rng >> 7; *rng ^= *rng << 17;
    const size_t span = b.v.size() - b.head;
    const size_t idx = b.head + (size_t)(*rng % span);
    std::swap(b.v[idx], b.v.back());  // order perturbation is the point
    const int32_t v = b.v.back();
    b.v.pop_back();
    if (b.empty()) { b.v.clear(); b.head = 0; }
    count--;
    return v;
  }

  bool empty() const { return count == 0; }
};

}  // namespace

namespace {

Puzzle make_puzzle(int32_t n, int32_t H, int32_t W, int32_t delta,
                   const uint8_t* static_block, const uint8_t* push,
                   const int32_t* init_xy, const int32_t* goal_xy,
                   int32_t num_goals) {
  const int K = 2 * delta + 1;
  const int HW = H * W;
  Puzzle pz;
  pz.n = n; pz.H = H; pz.W = W; pz.HW = HW; pz.num_goals = num_goals;
  pz.static_block.assign(static_block, static_block + (size_t)4 * n * HW);
  pz.contacts.assign((size_t)4 * n * n, {});
  for (int a = 0; a < 4; a++)
    for (int q = 0; q < n; q++)
      for (int o = 0; o < n; o++) {
        auto& lst = pz.contacts[(a * n + q) * n + o];
        const uint8_t* base = push + ((((size_t)a * n + q) * n + o) * K) * K;
        for (int ry = 0; ry < K; ry++)
          for (int rx = 0; rx < K; rx++)
            if (base[ry * K + rx])
              lst.push_back({(int16_t)(rx - delta), (int16_t)(ry - delta)});
      }
  pz.init_state.resize(n);
  for (int i = 0; i < n; i++)
    pz.init_state[i] = init_xy[2 * i + 1] * W + init_xy[2 * i];
  pz.goal_pos.resize(num_goals);
  for (int k = 0; k < num_goals; k++)
    pz.goal_pos[k] = goal_xy[2 * k + 1] * W + goal_xy[2 * k];
  return pz;
}

}  // namespace

// ------------------------------------------------------------------ C API

extern "C" {

// Computes the feasible-movement fixpoint; writes E as 4*n*HW bytes
// (E[a][o][p] = 1 iff transition feasible).  Returns 0 on success.
int32_t pw_build_graphs(int32_t n, int32_t H, int32_t W, int32_t delta,
                        const uint8_t* static_block, const uint8_t* push,
                        const int32_t* init_xy, uint8_t* out_E) {
  if (n <= 0 || n > 31 || H <= 0 || W <= 0) return -4;
  const Puzzle pz = make_puzzle(n, H, W, delta, static_block, push, init_xy,
                                nullptr, 0);
  const MovementGraphs g = build_graphs(pz);
  const size_t HW = (size_t)H * W;
  for (int a = 0; a < 4; a++)
    for (int o = 0; o < n; o++)
      std::memcpy(out_E + ((size_t)a * n + o) * HW, g.E[a * n + o].data(), HW);
  return 0;
}

// Returns plan length (>= 0), -1 no solution, -2 budget exhausted,
// -3 plan buffer too small, -4 invalid arguments, -5 memory limit,
// -7 cancelled (``cancel`` flag became nonzero).
static int64_t pw_solve_impl(
                 int32_t n, int32_t H, int32_t W, int32_t delta,
                 const uint8_t* static_block, const uint8_t* push,
                 const int32_t* init_xy, const int32_t* goal_xy,
                 int32_t num_goals, int32_t use_novelty, double time_limit,
                 double mem_limit_gb, int64_t max_expansions, uint64_t seed,
                 const volatile int32_t* cancel,
                 int32_t* out_plan, int64_t out_cap,
                 int64_t* out_expansions) {
  const size_t mem_limit_bytes =
      (size_t)((mem_limit_gb > 0 ? mem_limit_gb : 16.0) * 1e9);
  using Clock = std::chrono::steady_clock;
  const auto t_start = Clock::now();
  const auto deadline =
      t_start + std::chrono::duration_cast<Clock::duration>(
                    std::chrono::duration<double>(
                        time_limit > 0 ? time_limit : 1e9));

  if (n <= 0 || n > 31 || H <= 0 || W <= 0) return -4;
  const Puzzle pz = make_puzzle(n, H, W, delta, static_block, push, init_xy,
                                goal_xy, num_goals);
  const int num_goals_ = num_goals;
  (void)num_goals_;

  auto is_goal = [&](const int32_t* s) {
    for (int k = 0; k < num_goals; k++)
      if (s[k + 1] != pz.goal_pos[k]) return false;
    return true;
  };

  if (is_goal(pz.init_state.data())) { if (out_expansions) *out_expansions = 0; return 0; }

  RGD rgd(pz);
  if (time_limit > 0) {
    rgd.deadline = deadline;
    rgd.has_deadline = true;
  }
  rgd.cancel = cancel;

  // Node arena: states (n ints each) + parent/action/moved records.
  std::vector<int32_t> arena;
  std::vector<int32_t> parents;
  std::vector<int8_t> actions;
  std::vector<uint32_t> moved_masks;  // for deferred novelty evaluation
  arena.reserve((size_t)n * 1 << 20);

  auto add_node = [&](const int32_t* s, int32_t parent, int8_t action,
                      uint32_t moved) {
    const int32_t idx = (int32_t)parents.size();
    arena.insert(arena.end(), s, s + n);
    parents.push_back(parent);
    actions.push_back(action);
    moved_masks.push_back(moved);
    return idx;
  };

  // Start small and double on load: easy puzzles avoid zeroing a huge
  // table every call, hard searches grow as far as the memory cap allows.
  Visited visited(16, &arena, n);
  // use_novelty bit 0: lexicographic novelty stacking; bit 1: FIFO
  // within-bucket order (LIFO otherwise); bit 2: deferred (lazy)
  // heuristic evaluation — children are queued under their PARENT's
  // (novelty, rgd) key and evaluated once when popped, cutting heuristic
  // work from per-generated to per-expanded (the reference evaluates every
  // generated child, best_first_search.h:76-94 — eager mode matches that);
  // bit 3: prune non-novel states (novelty == 3) instead of ordering them
  // last — a width-based cut of the search space (cf. the BFWS family the
  // reference's novelty heuristic derives from, novelty.h:50-82).  Pruning
  // makes exhaustion inconclusive, so an empty frontier returns -2, not -1.
  // Bit 4: PREFERRED-OPERATOR dual queue — the child generated by the
  // RGD argmin chain's first agent move is queued separately and popped
  // at a 2:1 boost over the regular queue (classic helpful-action
  // acceleration; implies lazy evaluation, which is where the parent's
  // preferred action is computed).  Bit 5: epsilon type-based exploration
  // — 1/4 of pops take a uniformly random (bucket, element) instead of
  // the best bucket, escaping heuristic plateaus.
  //
  // Bit 6 ("gnov"): GOAL-PARTITIONED NOVELTY — the visited-position /
  // visited-pair tables are kept per achieved-goal count (BFWS-style
  // novelty(#g), Lipovetzky & Geffner): a state that re-visits positions
  // but with more goals done counts as novel again, so multi-goal
  // plateaus where one goal's progress erases the heuristic's guidance
  // for the next re-open exploration.  The reference keeps ONE global
  // table (novelty.cc:30-77).
  // Bit 7 ("la"): GREEDY LOOKAHEAD (YAHSP-style) — after expanding a
  // node, descend the RGD argmin chain: repeatedly apply the preferred
  // action while the estimate strictly improves (capped), adding every
  // rollout node to history/visited and queueing it under its OWN exact
  // key.  Reaches deep h-descents in one expansion instead of queue
  // round-trips.  Implies lazy.
  // Bit 8 ("dead"): DEAD-STATE PRUNING — drop INF-RGD states entirely
  // instead of overflow-queueing them.  INF almost always means a
  // movable is wedged where the (over-approximate) feasible-movement
  // graph proves the goal unreachable; the skip-set restriction of the
  // recursion makes rare false INFs possible, so this prunes (search
  // becomes inconclusive on exhaustion, like bit 3).
  BucketQueue frontier((use_novelty & 2) != 0);
  BucketQueue pref_queue((use_novelty & 2) != 0);
  const bool use_pref = (use_novelty & 16) != 0;
  const bool use_la = (use_novelty & 128) != 0;
  const bool lazy = (use_novelty & 4) != 0 || use_pref || use_la;
  const bool prune = (use_novelty & 8) != 0;
  const bool use_eps = (use_novelty & 32) != 0;
  const bool use_gnov = (use_novelty & 64) != 0;
  const bool use_dead = (use_novelty & 256) != 0;
  use_novelty &= 1;

  std::vector<Novelty> novelty_parts;
  const int nov_parts = use_gnov ? num_goals + 1 : 1;
  novelty_parts.reserve(nov_parts);
  for (int i = 0; i < nov_parts; i++) novelty_parts.emplace_back(n);
  auto nov_est = [&](const int32_t* s, uint32_t mv) -> float {
    int part = 0;
    if (use_gnov) {
      for (int k = 0; k < num_goals; k++)
        if (s[k + 1] == pz.goal_pos[k]) part++;
    }
    return novelty_parts[part].estimate(s, mv);
  };

  const int32_t root =
      add_node(pz.init_state.data(), -1, -1, (1u << n) - 1);
  visited.insert(pz.init_state.data(), root);
  if (!lazy) {
    const float nov = nov_est(pz.init_state.data(), (1u << n) - 1);
    const float h = rgd.estimate(pz.init_state.data());
    if (use_novelty) frontier.push(root, nov, h);
    else frontier.push(root, 1.f, h);
  } else {
    frontier.push(root, 1.f, 0.f);
  }

  // Deterministic action orders: xorshift-selected permutations remove
  // action-order bias (reference semantics: random_action_iterator.cc —
  // fixed-seed pre-shuffled permutations, cycled).
  static const int kPerms[24][4] = {
      {0,1,2,3},{0,1,3,2},{0,2,1,3},{0,2,3,1},{0,3,1,2},{0,3,2,1},
      {1,0,2,3},{1,0,3,2},{1,2,0,3},{1,2,3,0},{1,3,0,2},{1,3,2,0},
      {2,0,1,3},{2,0,3,1},{2,1,0,3},{2,1,3,0},{2,3,0,1},{2,3,1,0},
      {3,0,1,2},{3,0,2,1},{3,1,0,2},{3,1,2,0},{3,2,0,1},{3,2,1,0}};
  // seed = 0 keeps the historical default stream; any other seed yields an
  // independent deterministic action-order stream (restart diversity for
  // the portfolio: greedy best-first outcomes are ordering-sensitive).
  uint64_t perm_state = 0x9E3779B97F4A7C15ull ^ (seed * 0xBF58476D1CE4E5B9ull);
  if (perm_state == 0) perm_state = 0x9E3779B97F4A7C15ull;

  int64_t expansions = 0;
  std::vector<int32_t> child(n);

  auto finish = [&](int64_t rc) {
    if (out_expansions) *out_expansions = expansions;
    return rc;
  };

  // Independent stream for exploration pops so eps mode leaves the
  // action-order stream (and with it every existing seed's behavior)
  // untouched.
  uint64_t eps_state = perm_state ^ 0xD1B54A32D192ED03ull;
  uint64_t pref_tick = 0;

  while (frontier.count + pref_queue.count > 0) {
    if (max_expansions > 0 && expansions >= max_expansions) return finish(-2);
    // An estimate that ran out of budget mid-recursion (see
    // RGD::out_of_budget) unwound early; its value is unusable and the
    // attempt is over.
    if (rgd.expired) return finish(rgd.cancelled ? -7 : -2);
    if ((expansions & 0xFF) == 0) {
      // Cooperative cancellation (fleet: another solver already resolved
      // this instance) — checked on the same cadence as the deadline.
      if (cancel && *cancel) return finish(-7);
      if (Clock::now() > deadline) return finish(-2);
      // Reference-protocol analog of the 30 GB address-space rlimit
      // (utils/process.py:61-71): cap the search's dominant allocations.
      const size_t bytes = arena.capacity() * sizeof(int32_t) +
                           parents.capacity() * sizeof(int32_t) +
                           moved_masks.capacity() * sizeof(uint32_t) +
                           actions.capacity() + visited.mem_bytes();
      if (bytes > mem_limit_bytes) return finish(-5);
    }
    int32_t node;
    bool took_random = false;
    if (use_eps) {
      eps_state ^= eps_state << 13; eps_state ^= eps_state >> 7;
      eps_state ^= eps_state << 17;
      if ((eps_state & 3) == 0) {
        if (!frontier.empty()) node = frontier.pop_random(&eps_state);
        else node = pref_queue.pop_random(&eps_state);
        took_random = true;
      }
    }
    if (!took_random) {
      // 2:1 boost for the preferred queue (its states sit on the RGD
      // argmin chain); the regular queue still drains so non-preferred
      // strata are never starved.
      if (use_pref && !pref_queue.empty() &&
          (pref_tick++ % 3 != 2 || frontier.empty()))
        node = pref_queue.pop();
      else if (!frontier.empty())
        node = frontier.pop();
      else
        node = pref_queue.pop();
    }
    const int32_t* state = arena.data() + (size_t)node * n;
    expansions++;

    // Deferred evaluation: score the popped state once; its children are
    // queued under this key.  Non-novel states are cut here in prune mode
    // (their one evaluation already happened — no expansion).
    float node_nov = 1.f, node_h = 0.f;
    int node_pref = -1;
    if (lazy) {
      node_nov = (use_novelty || prune)
                     ? nov_est(state, moved_masks[node])
                     : 1.f;
      if (prune && node_nov >= 3.f && node != root) continue;
      node_h = rgd.estimate(
          state, (use_pref || use_la) ? &node_pref : nullptr);
      if (use_dead && node_h == kInf && node != root) continue;
      if (!use_novelty) node_nov = 1.f;
    }

    perm_state ^= perm_state << 13; perm_state ^= perm_state >> 7;
    perm_state ^= perm_state << 17;
    const int* order = kPerms[perm_state % 24];

    // Copy parent state: arena may reallocate when children are added.
    int32_t parent_state[32];
    std::memcpy(parent_state, state, n * sizeof(int32_t));

    int32_t la_child = -1;  // pref child held back for the lookahead rollout
    int32_t la_state[32];
    for (int ai = 0; ai < 4; ai++) {
      const int a = order[ai];
      uint32_t moved = 0;
      if (!step(pz, parent_state, a, child.data(), &moved)) continue;
      const int32_t idx = (int32_t)parents.size();
      if (!visited.insert(child.data(), idx)) continue;
      const int32_t cidx = add_node(child.data(), node, (int8_t)a, moved);
      if (is_goal(child.data())) {
        // Backtrack.
        std::vector<int32_t> plan;
        int32_t cur = cidx;
        while (actions[cur] >= 0) {
          plan.push_back(actions[cur]);
          cur = parents[cur];
        }
        if ((int64_t)plan.size() > out_cap) return finish(-3);
        for (size_t i = 0; i < plan.size(); i++)
          out_plan[i] = plan[plan.size() - 1 - i];
        if (out_expansions) *out_expansions = expansions;
        return (int64_t)plan.size();
      }
      if (lazy) {
        if (use_la && a == node_pref) {
          // The rollout below evaluates this child and queues it under
          // its own exact key (every break path queues or the attempt is
          // already over) — queueing it here too would only duplicate.
          la_child = cidx;
          std::memcpy(la_state, child.data(), n * sizeof(int32_t));
        } else if (use_pref && a == node_pref) {
          pref_queue.push(cidx, node_nov, node_h);
        } else {
          frontier.push(cidx, node_nov, node_h);
        }
      } else {
        float nov =
            use_novelty || prune ? nov_est(child.data(), moved) : 1.f;
        if (prune && nov >= 3.f) continue;
        if (!use_novelty) nov = 1.f;
        const float h = rgd.estimate(child.data());
        if (use_dead && h == kInf) continue;
        frontier.push(cidx, nov, h);
      }
    }

    // Greedy lookahead (bit 7): descend the RGD argmin chain from the
    // preferred child while the estimate strictly improves.  Every
    // rollout node enters history + visited and is queued under its own
    // (novelty, rgd) key — expansion of its remaining actions happens
    // when it is popped, so completeness of the unpruned modes is kept.
    // Reaches the bottom of long h-gradients (corridors, tool ferrying)
    // in ONE expansion instead of one queue round-trip per step.
    if (use_la && la_child >= 0) {
      float prev_h = node_h;
      int32_t cur_idx = la_child;
      int32_t cur[32];
      std::memcpy(cur, la_state, n * sizeof(int32_t));
      for (int li = 0;; li++) {
        const float nov2 = (use_novelty || prune)
                               ? nov_est(cur, moved_masks[cur_idx])
                               : 1.f;
        if (prune && nov2 >= 3.f) break;  // prune mode drops non-novel
        int pref2 = -1;
        const float h2 = rgd.estimate(cur, &pref2);
        if (rgd.expired) break;  // attempt over; queue entries moot
        if (use_dead && h2 == kInf) break;
        if (use_pref)
          pref_queue.push(cur_idx, use_novelty ? nov2 : 1.f, h2);
        else
          frontier.push(cur_idx, use_novelty ? nov2 : 1.f, h2);
        // Cap AFTER queueing: every created rollout node is queued on
        // every exit path (else it would sit in visited, unexpandable).
        if (li >= 96 || h2 >= prev_h || pref2 < 0) break;
        prev_h = h2;
        uint32_t mv = 0;
        if (!step(pz, cur, pref2, child.data(), &mv)) break;
        const int32_t idx = (int32_t)parents.size();
        if (!visited.insert(child.data(), idx)) break;
        cur_idx = add_node(child.data(), cur_idx, (int8_t)pref2, mv);
        expansions++;
        if (is_goal(child.data())) {
          std::vector<int32_t> plan;
          int32_t cur_n = cur_idx;
          while (actions[cur_n] >= 0) {
            plan.push_back(actions[cur_n]);
            cur_n = parents[cur_n];
          }
          if ((int64_t)plan.size() > out_cap) return finish(-3);
          for (size_t i = 0; i < plan.size(); i++)
            out_plan[i] = plan[plan.size() - 1 - i];
          if (out_expansions) *out_expansions = expansions;
          return (int64_t)plan.size();
        }
        std::memcpy(cur, child.data(), n * sizeof(int32_t));
      }
    }
  }
  if (out_expansions) *out_expansions = expansions;
  // A pruned search that drains its frontier proved nothing about the full
  // space: report budget-class inconclusiveness, not "no solution".
  // ("prune" cuts non-novel states; "dead" cuts INF-RGD states — both make
  // exhaustion inconclusive.  gnov/la only reorder; they stay complete.)
  return (prune || use_dead) ? -2 : -1;
}

int64_t pw_solve(int32_t n, int32_t H, int32_t W, int32_t delta,
                 const uint8_t* static_block, const uint8_t* push,
                 const int32_t* init_xy, const int32_t* goal_xy,
                 int32_t num_goals, int32_t use_novelty, double time_limit,
                 double mem_limit_gb, int64_t max_expansions, uint64_t seed,
                 const volatile int32_t* cancel,
                 int32_t* out_plan, int64_t out_cap,
                 int64_t* out_expansions) {
  try {
    return pw_solve_impl(n, H, W, delta, static_block, push, init_xy, goal_xy,
                         num_goals, use_novelty, time_limit, mem_limit_gb,
                         max_expansions, seed, cancel, out_plan, out_cap,
                         out_expansions);
  } catch (const std::bad_alloc&) {
    return -5;
  } catch (...) {
    return -6;
  }
}

}  // extern "C"
