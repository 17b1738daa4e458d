/* ref_model.c — single-core C measurement model of the Rust reference.
 *
 * A faithful port of the reference's serial query path and build pipeline,
 * used to measure the host-CPU baseline numbers behind bench.py's
 * REF_SINGLE_CORE_* constants.  Semantics sources (file:line in the
 * reference):
 *
 *   - priority_queue.rs:28-199  fixed-capacity sorted (dist,id) queue,
 *     dedup merge with "did_something" change flag
 *   - lib.rs:175-248            serial best-first closest_nodes with
 *     probe_depth and an unbounded visited set
 *   - lib.rs:250-277            closest_vectors (vector queue -> node queue)
 *   - search.rs:84-140          search_layers layer-descent driver
 *   - lib.rs:675-820            generate_layer: initial partitions (ef=6
 *     stack search), partition-group candidate pools (choose_n,
 *     lib.rs:1830-1880), sort+dedup+take(M), bidirectional insert
 *   - lib.rs:825-900            generate: shuffle, calculate_partitions
 *     (lib.rs:1883-1900), per-rung improve_index
 *   - lib.rs:1070-1154          link_layer_to_better_neighbors (relink):
 *     per-node stack search + positional insert into neighbor rows
 *   - lib.rs:1463-1500          stochastic_recall_at (10% sample, self-find)
 *   - lib.rs:1508-1546          improve_neighbors_upto loop-until-threshold
 *   - lib.rs:1546-1603,1665-1685 improve_index_at / improve_index drivers
 *
 * Deviations (all favorable to the reference, so measured throughput is an
 * upper bound on what the Rust would do single-core):
 *   - promotion (promote_at_layer) is NOT modelled: on the bench workload
 *     (10k x 100 unit vectors, cosine) recall reaches 1.0 without it, and
 *     when it does trigger in the reference it only ADDS work.
 *   - RNG is xorshift64* rather than StdRng; choose_n's index-space exclude
 *     quirk (lib.rs:1840 filters partition-0 index == node id) is replaced
 *     by the take-time self filter the reference also applies.
 *   - queue merge is a linear sorted-merge with hash dedup rather than the
 *     reference's binary-search inserts — strictly faster.
 *
 * The validated oracle for the query semantics is tests/ref_model.py, which
 * reproduces the reference's own golden search expectations
 * (src/lib.rs:2046-2068); this C port mirrors that model operation for
 * operation.
 *
 * Build:  gcc -O3 -march=native -o ref_model ref_model.c -lm
 * Usage:  ref_model <corpus.f32> <N> <D> <mode: build|query|all> [order]
 * Output: one JSON line per measurement on stdout.
 */

#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#define EMPTY INT32_MAX
#define EF_MAX 512
#define M_MAX 64
#define MAX_LAYERS 16
#define HS 8192 /* dedup hash slots (power of two) */

static int D;               /* vector dimensionality */
static const float *CORPUS; /* [N][D] */
static uint64_t N_EVALS = 0;

static double now_s(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

/* cosine on unit vectors: 1 - dot (benches/bench.rs:26-31) */
static inline float dist_vec(const float *a, const float *b) {
  float acc = 0.f;
  for (int i = 0; i < D; i++) acc += a[i] * b[i];
  return 1.0f - acc;
}
static inline float dist_to(const float *q, int32_t vid) {
  N_EVALS++;
  return dist_vec(q, CORPUS + (size_t)vid * D);
}

/* ---- xorshift64* RNG ---------------------------------------------------- */
static uint64_t RNG = 0x9E3779B97F4A7C15ull;
static inline uint64_t rng_next(void) {
  RNG ^= RNG >> 12;
  RNG ^= RNG << 25;
  RNG ^= RNG >> 27;
  return RNG * 0x2545F4914F6CDD1Dull;
}
static inline uint32_t rng_below(uint32_t n) { return rng_next() % n; }
static void shuffle_i32(int32_t *a, int n) {
  for (int i = n - 1; i > 0; i--) {
    int j = (int)rng_below((uint32_t)i + 1);
    int32_t t = a[i];
    a[i] = a[j];
    a[j] = t;
  }
}

/* ---- pair sorting (dist asc, id asc) ------------------------------------ */
typedef struct {
  float d;
  int32_t id;
} Pair;
static int pair_cmp(const void *pa, const void *pb) {
  const Pair *a = (const Pair *)pa, *b = (const Pair *)pb;
  if (a->d < b->d) return -1;
  if (a->d > b->d) return 1;
  return (a->id > b->id) - (a->id < b->id);
}
/* insertion sort for the small fresh lists (<= M0) */
static void pair_isort(Pair *p, int n) {
  for (int i = 1; i < n; i++) {
    Pair key = p[i];
    int j = i - 1;
    while (j >= 0 && (p[j].d > key.d || (p[j].d == key.d && p[j].id > key.id))) {
      p[j + 1] = p[j];
      j--;
    }
    p[j + 1] = key;
  }
}

/* ---- dedup hash (generation-stamped) ------------------------------------ */
static int32_t hash_id[HS];
static uint32_t hash_gen[HS];
static uint32_t hash_cur = 0;
static void hash_reset(void) { hash_cur++; }
/* returns 1 if id was already present, else inserts and returns 0 */
static inline int hash_seen(int32_t id) {
  uint32_t h = ((uint32_t)id * 2654435761u) & (HS - 1);
  while (hash_gen[h] == hash_cur) {
    if (hash_id[h] == id) return 1;
    h = (h + 1) & (HS - 1);
  }
  hash_gen[h] = hash_cur;
  hash_id[h] = id;
  return 0;
}

/* ---- fixed-capacity sorted queue (priority_queue.rs) -------------------- */
typedef struct {
  int32_t ids[EF_MAX];
  float ds[EF_MAX];
  int size, cap;
} Q;
static void q_init(Q *q, int cap) {
  q->size = 0;
  q->cap = cap < EF_MAX ? cap : EF_MAX;
}
/* merge of sorted fresh pairs; keep-min dedup; truncate to cap; returns
 * "did_something" — whether the kept prefix changed
 * (priority_queue.rs:109-153, modelled as ref_model.py merge_pairs) */
static int q_merge(Q *q, const Pair *fresh, int nf) {
  if (nf == 0) return 0; /* no pairs -> no change (priority_queue.rs:112) */
  static Pair out[EF_MAX];
  int no = 0, i = 0, j = 0, changed = 0;
  hash_reset();
  while (no < q->cap && (i < q->size || j < nf)) {
    Pair pick;
    int take_q;
    if (i >= q->size) take_q = 0;
    else if (j >= nf) take_q = 1;
    else {
      take_q = (q->ds[i] < fresh[j].d ||
                (q->ds[i] == fresh[j].d && q->ids[i] <= fresh[j].id));
    }
    if (take_q) {
      pick.d = q->ds[i];
      pick.id = q->ids[i];
      i++;
    } else {
      pick = fresh[j];
      j++;
    }
    if (pick.id == EMPTY || hash_seen(pick.id)) continue;
    if (no >= q->size || q->ids[no] != pick.id) changed = 1;
    out[no++] = pick;
  }
  if (no != q->size) changed = 1;
  for (int k = 0; k < no; k++) {
    q->ids[k] = out[k].id;
    q->ds[k] = out[k].d;
  }
  q->size = no;
  return changed;
}
/* single insert, dedup, used by the bidirectional pass
 * (priority_queue.rs:70-107) */
static void q_insert(Q *q, int32_t id, float d) {
  for (int k = 0; k < q->size; k++)
    if (q->ids[k] == id) return;
  int pos = q->size;
  for (int k = 0; k < q->size; k++)
    if (d < q->ds[k] || (d == q->ds[k] && id < q->ids[k])) {
      pos = k;
      break;
    }
  if (pos >= q->cap) return;
  int end = q->size < q->cap ? q->size : q->cap - 1;
  for (int k = end; k > pos; k--) {
    q->ids[k] = q->ids[k - 1];
    q->ds[k] = q->ds[k - 1];
  }
  q->ids[pos] = id;
  q->ds[pos] = d;
  if (q->size < q->cap) q->size++;
}

/* ---- layer -------------------------------------------------------------- */
typedef struct {
  int n, m;
  int32_t *nodes; /* [n] sorted vector ids */
  int32_t *nbr;   /* [n*m] node ids, EMPTY padded */
} CLayer;
static int layer_node_of(const CLayer *L, int32_t vid) {
  int lo = 0, hi = L->n - 1;
  while (lo <= hi) {
    int mid = (lo + hi) >> 1;
    if (L->nodes[mid] < vid) lo = mid + 1;
    else if (L->nodes[mid] > vid) hi = mid - 1;
    else return mid;
  }
  return -1;
}

/* ---- visit heap (pop order = global min (d,id), matching the re-sorted
 * visit list of lib.rs:191-244 / ref_model.py closest_nodes) -------------- */
static Pair heap_buf[1 << 20];
static int heap_n;
static inline int heap_lt(Pair a, Pair b) {
  return a.d < b.d || (a.d == b.d && a.id < b.id);
}
static void heap_push(Pair p) {
  if (heap_n >= (1 << 20)) return; /* bounded safety; never hit at bench scale */
  int i = heap_n++;
  heap_buf[i] = p;
  while (i > 0) {
    int par = (i - 1) >> 1;
    if (heap_lt(heap_buf[i], heap_buf[par])) {
      Pair t = heap_buf[i];
      heap_buf[i] = heap_buf[par];
      heap_buf[par] = t;
      i = par;
    } else break;
  }
}
static Pair heap_pop(void) {
  Pair top = heap_buf[0];
  heap_buf[0] = heap_buf[--heap_n];
  int i = 0;
  for (;;) {
    int l = 2 * i + 1, r = l + 1, s = i;
    if (l < heap_n && heap_lt(heap_buf[l], heap_buf[s])) s = l;
    if (r < heap_n && heap_lt(heap_buf[r], heap_buf[s])) s = r;
    if (s == i) break;
    Pair t = heap_buf[i];
    heap_buf[i] = heap_buf[s];
    heap_buf[s] = t;
    i = s;
  }
  return top;
}

/* visited stamps, sized to the max layer node count */
static uint32_t *visited;
static uint32_t visited_cur = 0;

/* ---- closest_nodes (lib.rs:175-248) ------------------------------------- */
static void closest_nodes(const CLayer *L, const float *qv, Q *q,
                          int probe_depth, int32_t exclude_vec) {
  heap_n = 0;
  visited_cur++;
  for (int k = 0; k < q->size; k++) {
    Pair p = {q->ds[k], q->ids[k]};
    heap_push(p);
    visited[q->ids[k]] = visited_cur;
  }
  Pair fresh[M_MAX];
  while (heap_n > 0) {
    int node = heap_pop().id;
    const int32_t *row = L->nbr + (size_t)node * L->m;
    int nf = 0;
    for (int k = 0; k < L->m; k++) {
      int32_t nb = row[k];
      if (nb == EMPTY || visited[nb] == visited_cur) continue;
      fresh[nf].id = nb;
      fresh[nf].d = dist_to(qv, L->nodes[nb]);
      nf++;
    }
    pair_isort(fresh, nf);
    for (int k = 0; k < nf; k++) {
      visited[fresh[k].id] = visited_cur;
      heap_push(fresh[k]);
    }
    int nq = nf;
    if (exclude_vec != EMPTY) { /* filter queued results (search.rs:131) */
      nq = 0;
      for (int k = 0; k < nf; k++)
        if (L->nodes[fresh[k].id] != exclude_vec) fresh[nq++] = fresh[k];
    }
    int changed = q_merge(q, fresh, nq);
    if (!changed && --probe_depth == 0) break;
  }
}

/* ---- closest_vectors (lib.rs:250-277) ----------------------------------- */
static int closest_vectors(const CLayer *L, const float *qv, const Q *cands,
                           int cc, int probe_depth, int32_t exclude_vec,
                           Pair *out) {
  Q nq;
  q_init(&nq, cands->cap);
  Pair seed[EF_MAX];
  int ns = 0;
  for (int k = 0; k < cands->size; k++) {
    int node = layer_node_of(L, cands->ids[k]);
    if (node >= 0) {
      seed[ns].id = node;
      seed[ns].d = cands->ds[k];
      ns++;
    }
  }
  pair_isort(seed, ns);
  q_merge(&nq, seed, ns);
  closest_nodes(L, qv, &nq, probe_depth, exclude_vec);
  int no = nq.size < cc ? nq.size : cc;
  for (int k = 0; k < no; k++) {
    out[k].id = L->nodes[nq.ids[k]];
    out[k].d = nq.ds[k];
  }
  return no;
}

/* ---- search_layers (search.rs:84-140) ----------------------------------- */
static void search_layers(const CLayer *stack, int nlayers, const float *qv,
                          int ef, int ulcc, int probe_depth,
                          int32_t exclude_vec, Q *cands) {
  q_init(cands, ef);
  int32_t entry = stack[0].nodes[0];
  Pair seed = {dist_to(qv, entry), entry};
  q_merge(cands, &seed, 1);
  Pair closest[EF_MAX];
  for (int i = 0; i < nlayers; i++) {
    int cc = (nlayers == 1 || i == nlayers - 1) ? ef : ulcc;
    int nc = closest_vectors(&stack[i], qv, cands, cc, probe_depth,
                             exclude_vec, closest);
    q_merge(cands, closest, nc);
  }
}

/* ---- build: generate_layer (lib.rs:675-820) ----------------------------- */
#define IP_EF 6 /* initial_partition_search (parameters.rs:57-61) */

static int cmp_i32(const void *a, const void *b) {
  int32_t x = *(const int32_t *)a, y = *(const int32_t *)b;
  return (x > y) - (x < y);
}

static void generate_layer(CLayer *stack, int nlayers, CLayer *out,
                           const int32_t *vs_in, int n, int m) {
  int32_t *vs = malloc(n * sizeof(int32_t));
  memcpy(vs, vs_in, n * sizeof(int32_t));
  /* sort first (lib.rs:686) */
  qsort(vs, n, sizeof(int32_t), cmp_i32);
  out->n = n;
  out->m = m;
  out->nodes = vs;
  out->nbr = malloc((size_t)n * m * sizeof(int32_t));

  CLayer tmp = *out; /* nodes available for node_of lookups */

  /* 1. initial partitions: per node, ef=6 stack search (search.rs:32-70) */
  int ip_cap = IP_EF;
  int32_t *ip_ids = malloc((size_t)n * ip_cap * sizeof(int32_t));
  float *ip_ds = malloc((size_t)n * ip_cap * sizeof(float));
  int *ip_cnt = calloc(n, sizeof(int));
  for (int node = 0; node < n; node++) {
    const float *qv = CORPUS + (size_t)vs[node] * D;
    Pair got[EF_MAX];
    int ng = 0;
    if (nlayers == 0) { /* compare_all within the slice (search.rs:10-30) */
      for (int w = 0; w < n && ng < EF_MAX; w++) {
        if (w == node) continue;
        got[ng].id = vs[w];
        got[ng].d = dist_to(qv, vs[w]);
        ng++;
      }
      qsort(got, ng, sizeof(Pair), pair_cmp);
      if (ng > ip_cap) ng = ip_cap;
    } else {
      Q q;
      search_layers(stack, nlayers, qv, IP_EF, IP_EF, 2, EMPTY, &q);
      for (int k = 0; k < q.size; k++) {
        if (q.ids[k] == vs[node]) continue; /* filter self (search.rs:78) */
        got[ng].id = q.ids[k];
        got[ng].d = q.ds[k];
        ng++;
      }
    }
    /* map vector ids -> node ids in THIS layer (search.rs:53-62) */
    int c = 0;
    for (int k = 0; k < ng && c < ip_cap; k++) {
      int nid = layer_node_of(&tmp, got[k].id);
      if (nid < 0) continue;
      ip_ids[(size_t)node * ip_cap + c] = nid;
      ip_ds[(size_t)node * ip_cap + c] = got[k].d;
      c++;
    }
    ip_cnt[node] = c;
  }

  /* 2. partition groups keyed by first super (lib.rs:712-716) */
  int32_t *grp_head = malloc(n * sizeof(int32_t));
  int32_t *grp_next = malloc(n * sizeof(int32_t));
  int32_t *grp_size = calloc(n, sizeof(int32_t));
  memset(grp_head, -1, n * sizeof(int32_t));
  memset(grp_next, -1, n * sizeof(int32_t));
  for (int node = n - 1; node >= 0; node--) { /* head-insert keeps order */
    if (ip_cnt[node] == 0) continue;
    int g = ip_ids[(size_t)node * ip_cap];
    grp_next[node] = grp_head[g];
    grp_head[g] = node;
    grp_size[g]++;
  }

  /* 3. per-node candidate pool (lib.rs:718-780) */
  Pair *dl = malloc((size_t)(ip_cap + 5 * M_MAX + M_MAX) * sizeof(Pair));
  int32_t *pool = malloc((size_t)(6 * M_MAX) * sizeof(int32_t));
  int32_t parts[IP_EF + 1];
  for (int node = 0; node < n; node++) {
    const float *qv = CORPUS + (size_t)vs[node] * D;
    int nd = ip_cnt[node];
    for (int k = 0; k < nd; k++) {
      dl[k].id = ip_ids[(size_t)node * ip_cap + k];
      dl[k].d = ip_ds[(size_t)node * ip_cap + k];
    }
    /* partitions = groups of my supers; fall back to own group (top layer) */
    int np = 0, total = 0;
    for (int k = 0; k < nd; k++) {
      int g = ip_ids[(size_t)node * ip_cap + k];
      if (grp_size[g] > 0) {
        parts[np++] = g;
        total += grp_size[g];
      }
    }
    if (np == 0) {
      int g = nd > 0 ? ip_ids[(size_t)node * ip_cap] : node;
      /* top layer: own partition = group containing this node; find it by
       * first-super key (every node keyed by its own first super) */
      if (grp_size[g] == 0) g = node;
      if (grp_size[g] == 0) { /* singleton fallback: whole slice group scan */
        for (int gg = 0; gg < n; gg++)
          if (grp_size[gg] > 0) {
            g = gg;
            break;
          }
      }
      parts[np++] = g;
      total += grp_size[g];
    }
    int choice = 5 * m;
    if (choice > total) choice = total;
    /* choose_n (lib.rs:1854-1862): since choice_count <= total, the
     * `total*2 > n` test always selects choose_n_1 — enumerate + shuffle +
     * truncate (lib.rs:1830-1852).  The Exp(1) branch is dead in practice. */
    static int32_t all[1 << 20];
    int na = 0;
    for (int p = 0; p < np && na < (1 << 20); p++)
      for (int it = grp_head[parts[p]]; it != -1 && na < (1 << 20);
           it = grp_next[it])
        all[na++] = it;
    shuffle_i32(all, na);
    int npool = na < choice ? na : choice;
    memcpy(pool, all, npool * sizeof(int32_t));
    for (int k = 0; k < npool; k++) {
      dl[nd + k].id = pool[k];
      dl[nd + k].d = dist_to(qv, vs[pool[k]]);
    }
    nd += npool;
    qsort(dl, nd, sizeof(Pair), pair_cmp);
    /* dedup + filter self + take m (lib.rs:757-770) */
    int32_t *row = out->nbr + (size_t)node * m;
    hash_reset();
    int c = 0;
    for (int k = 0; k < nd && c < m; k++) {
      if (dl[k].id == node || hash_seen(dl[k].id)) continue;
      row[c++] = dl[k].id;
    }
    for (; c < m; c++) row[c] = EMPTY;
  }
  free(dl);
  free(pool);

  /* 4. bidirectional (lib.rs:790-818): queues seeded from rows, then each
   * node inserts itself into its neighbors' queues */
  Q *qs = malloc(n * sizeof(Q));
  float *row_d = malloc((size_t)n * m * sizeof(float));
  for (int node = 0; node < n; node++) {
    const float *qv = CORPUS + (size_t)vs[node] * D;
    q_init(&qs[node], m);
    const int32_t *row = out->nbr + (size_t)node * m;
    for (int k = 0; k < m && row[k] != EMPTY; k++) {
      float d = dist_to(qv, vs[row[k]]); /* neighbor_distances kept in Rust;
                                            recompute here (counted) */
      qs[node].ids[qs[node].size] = row[k];
      qs[node].ds[qs[node].size] = d;
      row_d[(size_t)node * m + k] = d;
      qs[node].size++;
    }
  }
  for (int node = 0; node < n; node++) {
    const int32_t *row = out->nbr + (size_t)node * m;
    for (int k = 0; k < m && row[k] != EMPTY; k++)
      q_insert(&qs[row[k]], node, row_d[(size_t)node * m + k]);
  }
  for (int node = 0; node < n; node++) {
    int32_t *row = out->nbr + (size_t)node * m;
    for (int k = 0; k < m; k++)
      row[k] = k < qs[node].size ? qs[node].ids[k] : EMPTY;
  }
  free(qs);
  free(row_d);
  free(ip_ids);
  free(ip_ds);
  free(ip_cnt);
  free(grp_head);
  free(grp_next);
  free(grp_size);
}

/* ---- improve loops (lib.rs:1070-1154, 1463-1546, 1546-1685) ------------- */
#define OP_EF 300 /* optimization.search defaults (parameters.rs:10-16) */
#define OP_PD 2
#define RECALL_PROP 0.1f
#define NBR_THRESH 0.01f
#define PROMO_THRESH 0.01f

static float stochastic_recall_at(const CLayer *stack, int nlayers, int at) {
  const CLayer *L = &stack[at];
  int total = L->n;
  int selection = (int)(total * RECALL_PROP);
  if (selection < 1) selection = 1;
  int32_t *vecs = malloc(total * sizeof(int32_t));
  memcpy(vecs, L->nodes, total * sizeof(int32_t));
  if (selection != total) shuffle_i32(vecs, total);
  int relevant = 0;
  Q q;
  for (int i = 0; i < selection; i++) {
    const float *qv = CORPUS + (size_t)vecs[i] * D;
    search_layers(stack, nlayers, qv, OP_EF, OP_EF, OP_PD, EMPTY, &q);
    for (int k = 0; k < q.size; k++)
      if (q.ids[k] == vecs[i]) {
        relevant++;
        break;
      }
  }
  free(vecs);
  return (float)relevant / (float)selection;
}

/* link_layer_to_better_neighbors (lib.rs:1070-1154): search the pseudo
 * (snapshot) stack per node, positional insert into live neighbor rows.
 * NOTE: the reference takes only hnsw-level neighborhood_size (= M = 24)
 * matches per node even on the 48-wide bottom layer (lib.rs:1092,1118). */
#define RELINK_TAKE 24
static int relink_layer(CLayer *stack, int nlayers, int layer_from_top) {
  CLayer *L = &stack[layer_from_top];
  CLayer pseudo = *L;
  pseudo.nbr = malloc((size_t)L->n * L->m * sizeof(int32_t));
  memcpy(pseudo.nbr, L->nbr, (size_t)L->n * L->m * sizeof(int32_t));
  CLayer pstack[MAX_LAYERS];
  for (int i = 0; i < layer_from_top; i++) pstack[i] = stack[i];
  pstack[layer_from_top] = pseudo;
  int m = L->m, count = 0;
  Q q;
  for (int node = 0; node < L->n; node++) {
    int32_t vec = L->nodes[node];
    const float *qv = CORPUS + (size_t)vec * D;
    search_layers(pstack, layer_from_top + 1, qv, OP_EF, OP_EF, OP_PD, vec, &q);
    int nm = q.size < RELINK_TAKE ? q.size : RELINK_TAKE;
    for (int k = 0; k < nm; k++) {
      int32_t nb_vec = q.ids[k];
      float distance = q.ds[k];
      if (nb_vec == vec) break;
      int neighbor = layer_node_of(&pseudo, nb_vec);
      if (neighbor < 0) continue;
      int32_t *row = L->nbr + (size_t)neighbor * m;
      const float *nbv = CORPUS + (size_t)nb_vec * D;
      int pos = -1;
      for (int p = 0; p < m; p++) {
        int32_t other = row[p];
        if (other == EMPTY || other == node) {
          pos = p;
          break;
        }
        float od = dist_to(nbv, pseudo.nodes[other]);
        if (distance < od || (distance == od && node < other)) {
          pos = p;
          break;
        }
      }
      if (pos < 0 || row[pos] == node) continue;
      for (int p = m - 1; p > pos; p--) row[p] = row[p - 1];
      row[pos] = node;
      count++;
    }
  }
  free(pseudo.nbr);
  return count;
}

static float improve_neighbors_upto(CLayer *stack, int nlayers, int upto,
                                    float last_recall_in, int has_last) {
  float last_recall = has_last ? last_recall_in : 0.0f;
  float last_improvement = 1.0f;
  while (last_improvement >= NBR_THRESH && last_recall < 1.0f) {
    for (int l = 0; l < upto; l++) relink_layer(stack, nlayers, l);
    float recall = stochastic_recall_at(stack, nlayers, upto - 1);
    last_improvement = recall - last_recall;
    last_recall = recall;
  }
  return last_recall;
}

/* improve_index_at minus promotion (lib.rs:1546-1603) */
static float improve_index_at(CLayer *stack, int nlayers, int layer_from_top) {
  float recall = stochastic_recall_at(stack, nlayers, layer_from_top);
  float improvement = 1.0f;
  int bailout = 1;
  while (improvement >= PROMO_THRESH && recall < 1.0f && bailout != 0) {
    float last_recall = recall;
    for (int clft = 0; clft <= layer_from_top && bailout != 0; clft++)
      recall = improve_neighbors_upto(stack, nlayers, clft + 1, 0, 0);
    bailout--;
    improvement = recall - last_recall;
  }
  return recall;
}

static float improve_index(CLayer *stack, int nlayers) {
  float recall = 0.f;
  for (int lft = 0; lft < nlayers; lft++)
    recall = improve_index_at(stack, nlayers, lft);
  return recall;
}

/* calculate_partitions (lib.rs:1883-1900): bottom-up then reversed */
static int calc_partitions(int total, int order, int *parts_top_first) {
  int sizes[MAX_LAYERS], c = 0, size = total;
  int layer_count = (int)ceilf(logf((float)total) / logf((float)order));
  if (layer_count < 1) layer_count = 1;
  for (int i = 0; i < layer_count && c < MAX_LAYERS; i++) {
    sizes[c++] = size;
    size /= order;
  }
  for (int i = 0; i < c; i++) parts_top_first[i] = sizes[c - 1 - i];
  return c;
}

/* generate (lib.rs:825-900): shuffle, build rungs top-down, improve per rung */
static int generate(CLayer *stack, int32_t *vs, int total, int order, int m,
                    int m0, float *final_recall) {
  shuffle_i32(vs, total);
  int parts[MAX_LAYERS];
  int nparts = calc_partitions(total, order, parts);
  int nlayers = 0;
  for (int i = 0; i < nparts; i++) {
    int level = nparts - i - 1;
    int length = parts[i] < total ? parts[i] : total;
    int mm = level == 0 ? m0 : m;
    generate_layer(stack, nlayers, &stack[nlayers], vs, length, mm);
    nlayers++;
    *final_recall = improve_index(stack, nlayers);
  }
  return nlayers;
}

/* ---- ground truth + recall@10 ------------------------------------------- */
static void brute_top10(const float *qv, int n, int32_t *out_ids) {
  Pair best[10];
  int nb = 0;
  for (int i = 0; i < n; i++) {
    float d = dist_vec(qv, CORPUS + (size_t)i * D);
    if (nb < 10) {
      best[nb].d = d;
      best[nb].id = i;
      nb++;
      pair_isort(best, nb);
    } else if (d < best[9].d || (d == best[9].d && i < best[9].id)) {
      best[9].d = d;
      best[9].id = i;
      pair_isort(best, 10);
    }
  }
  for (int k = 0; k < 10; k++) out_ids[k] = best[k].id;
}

int main(int argc, char **argv) {
  if (argc < 5) {
    fprintf(stderr, "usage: %s corpus.f32 N D build|query|all [order]\n",
            argv[0]);
    return 2;
  }
  const char *path = argv[1];
  int n = atoi(argv[2]);
  D = atoi(argv[3]);
  const char *mode = argv[4];
  int order = argc > 5 ? atoi(argv[5]) : 12;
  int m = 24, m0 = 48;

  float *data = malloc((size_t)n * D * sizeof(float));
  FILE *f = fopen(path, "rb");
  if (!f || fread(data, sizeof(float), (size_t)n * D, f) != (size_t)n * D) {
    fprintf(stderr, "failed to read %s\n", path);
    return 2;
  }
  fclose(f);
  CORPUS = data;
  visited = calloc(n, sizeof(uint32_t));

  CLayer stack[MAX_LAYERS];
  int32_t *vs = malloc(n * sizeof(int32_t));
  for (int i = 0; i < n; i++) vs[i] = i;

  int do_build = strcmp(mode, "build") == 0 || strcmp(mode, "all") == 0;
  int do_query = strcmp(mode, "query") == 0 || strcmp(mode, "all") == 0;

  float recall = 0.f;
  N_EVALS = 0;
  double t0 = now_s();
  int nlayers = generate(stack, vs, n, order, m, m0, &recall);
  double build_s = now_s() - t0;
  uint64_t build_evals = N_EVALS;
  if (do_build) {
    printf("{\"phase\": \"build\", \"seconds\": %.3f, \"vec_per_s\": %.1f, "
           "\"evals\": %llu, \"ns_per_eval\": %.2f, \"layers\": %d, "
           "\"stochastic_recall\": %.4f}\n",
           build_s, n / build_s, (unsigned long long)build_evals,
           1e9 * build_s / (double)build_evals, nlayers, recall);
    fflush(stdout);
  }

  if (do_query) {
    int nq = n < 10000 ? n : 10000;
    int32_t *gt = malloc((size_t)nq * 10 * sizeof(int32_t));
    for (int i = 0; i < nq; i++)
      brute_top10(CORPUS + (size_t)i * D, n, gt + (size_t)i * 10);
    int efs[] = {300, 100, 40, 24, 12};
    for (int e = 0; e < 5; e++) {
      int ef = efs[e];
      Q q;
      long hits = 0;
      N_EVALS = 0;
      double q0 = now_s();
      for (int i = 0; i < nq; i++) {
        const float *qv = CORPUS + (size_t)i * D;
        search_layers(stack, nlayers, qv, ef, ef, OP_PD, EMPTY, &q);
        int top = q.size < 10 ? q.size : 10;
        const int32_t *g = gt + (size_t)i * 10;
        for (int k = 0; k < top; k++)
          for (int j = 0; j < 10; j++)
            if (q.ids[k] == g[j]) {
              hits++;
              break;
            }
      }
      double qs = now_s() - q0;
      printf("{\"phase\": \"query\", \"ef\": %d, \"probe_depth\": %d, "
             "\"queries\": %d, \"seconds\": %.3f, \"qps\": %.1f, "
             "\"recall_at_10\": %.4f, \"evals\": %llu, \"ns_per_eval\": "
             "%.2f}\n",
             ef, OP_PD, nq, qs, nq / qs, hits / (10.0 * nq),
             (unsigned long long)N_EVALS, 1e9 * qs / (double)N_EVALS);
      fflush(stdout);
    }
    free(gt);
  }
  return 0;
}
