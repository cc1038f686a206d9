// Exact host solvers of the port: the oracles the card's approximate
// kernels are held to (the port's own copy of the two solvers in
// mars_tpu/native/mars_native.cpp; the RLE codec there has its numpy twin
// in mars_tpu_torch/core/rle.py).
//
//   emd_uniform:  exact EMD with uniform marginals by successive shortest
//                 paths (integer-scaled supplies, Dijkstra with Johnson
//                 potentials); the reference's ot.emd2 on a=1/t, b=1/c
//   lsa_maximize: exact rectangular linear assignment, maximised (shortest
//                 augmenting paths, Jonker-Volgenant style); scipy's
//                 linear_sum_assignment(maximize=True)
//
// Plain C linkage for ctypes; built by mars_tpu_torch/native/__init__.py.
#include <algorithm>
#include <cmath>
#include <limits>
#include <queue>
#include <vector>

namespace {

constexpr double INF = std::numeric_limits<double>::infinity();

}  // namespace

extern "C" {

// Exact EMD between uniform marginals over a dense t x c cost matrix.
// Solves the transportation problem with supplies c (integer, per row) and
// demands t (per column) — total flow t*c — and returns cost/(t*c), which
// equals ot.emd2(a=1/t, b=1/c, M).
double emd_uniform(const double* cost, int t, int c) {
  const int n = t + c + 2;       // source, rows, cols, sink
  const int S = 0, T = n - 1;
  // node supplies: every row node needs c units, every col node t units.
  std::vector<long long> row_left(t, c), col_left(c, t);
  std::vector<double> pot(n, 0.0);  // Johnson potentials
  std::vector<double> dist(n);
  std::vector<int> prev_node(n);
  // residual flows on row->col arcs (flow can be pushed back)
  std::vector<long long> flow(static_cast<size_t>(t) * c, 0);

  long long remaining = static_cast<long long>(t) * c;
  double total_cost = 0.0;

  // First potentials: one Bellman-Ford-ish relaxation suffices because all
  // arcs go S->row(0 cost), row->col(cost), col->T(0): dist(row)=0,
  // dist(col)=min_i cost, dist(T)=min over cols.
  for (int j = 0; j < c; ++j) {
    double m = INF;
    for (int i = 0; i < t; ++i) m = std::min(m, cost[i * c + j]);
    pot[1 + t + j] = m;
  }
  {
    double m = INF;
    for (int j = 0; j < c; ++j) m = std::min(m, pot[1 + t + j]);
    pot[T] = m;
  }

  while (remaining > 0) {
    // Dijkstra on reduced costs over the residual graph.
    std::fill(dist.begin(), dist.end(), INF);
    std::vector<bool> done(n, false);
    dist[S] = 0.0;
    prev_node[S] = -1;
    using QE = std::pair<double, int>;
    std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;
    pq.push({0.0, S});
    while (!pq.empty()) {
      auto [d, u] = pq.top();
      pq.pop();
      if (done[u]) continue;
      done[u] = true;
      if (u == S) {
        for (int i = 0; i < t; ++i) {
          if (row_left[i] > 0) {
            // reduced cost of the S->row arc (arc cost 0)
            double rc = 0.0 + pot[S] - pot[1 + i];
            if (rc < 0) rc = 0;  // numerical guard
            double nd = d + rc;
            if (nd < dist[1 + i]) {
              dist[1 + i] = nd;
              prev_node[1 + i] = S;
              pq.push({nd, 1 + i});
            }
          }
        }
      } else if (u >= 1 && u < 1 + t) {
        int i = u - 1;
        for (int j = 0; j < c; ++j) {
          double rc = cost[i * c + j] + pot[u] - pot[1 + t + j];
          double nd = d + std::max(rc, 0.0);  // clamp = numerical guard
          int v = 1 + t + j;
          if (nd < dist[v]) {
            dist[v] = nd;
            prev_node[v] = u;
            pq.push({nd, v});
          }
        }
      } else if (u >= 1 + t && u < 1 + t + c) {
        int j = u - 1 - t;
        // col -> sink
        if (col_left[j] > 0) {
          double rc = 0.0 + pot[u] - pot[T];
          double nd = d + std::max(rc, 0.0);
          if (nd < dist[T]) {
            dist[T] = nd;
            prev_node[T] = u;
            pq.push({nd, T});
          }
        }
        // col -> row back arcs (cancel existing flow)
        for (int i = 0; i < t; ++i) {
          if (flow[static_cast<size_t>(i) * c + j] > 0) {
            double rc = -cost[i * c + j] + pot[u] - pot[1 + i];
            double nd = d + std::max(rc, 0.0);  // clamp = numerical guard
            int v = 1 + i;
            if (nd < dist[v]) {
              dist[v] = nd;
              prev_node[v] = u;
              pq.push({nd, v});
            }
          }
        }
      }
    }
    if (dist[T] == INF) return -1.0;  // infeasible (should not happen)

    for (int u = 0; u < n; ++u)
      if (dist[u] < INF) pot[u] += dist[u];

    // find bottleneck along path
    long long push = remaining;
    for (int v = T; prev_node[v] != -1; v = prev_node[v]) {
      int u = prev_node[v];
      if (u == S) {
        push = std::min(push, row_left[v - 1]);
      } else if (u >= 1 && u < 1 + t && v >= 1 + t) {
        // forward row->col: unbounded capacity
      } else if (u >= 1 + t && v == T) {
        push = std::min(push, col_left[u - 1 - t]);
      } else if (u >= 1 + t && v >= 1 && v < 1 + t) {
        // back arc col->row: capacity = existing flow
        int j = u - 1 - t;
        int i = v - 1;
        push = std::min(push, flow[static_cast<size_t>(i) * c + j]);
      }
    }
    // apply
    for (int v = T; prev_node[v] != -1; v = prev_node[v]) {
      int u = prev_node[v];
      if (u == S) {
        row_left[v - 1] -= push;
      } else if (u >= 1 && u < 1 + t && v >= 1 + t && v < T) {
        int i = u - 1, j = v - 1 - t;
        flow[static_cast<size_t>(i) * c + j] += push;
        total_cost += push * cost[i * c + j];
      } else if (u >= 1 + t && v == T) {
        col_left[u - 1 - t] -= push;
      } else if (u >= 1 + t && v >= 1 && v < 1 + t) {
        int j = u - 1 - t, i = v - 1;
        flow[static_cast<size_t>(i) * c + j] -= push;
        total_cost -= push * cost[i * c + j];
      }
    }
    remaining -= push;
  }
  return total_cost / (static_cast<double>(t) * c);
}

// Exact rectangular assignment, maximize total score; t <= n.
// Shortest-augmenting-path (Jonker-Volgenant) on negated scores.
// out_cols[i] = assigned column of row i.
void lsa_maximize(const double* score, int t, int n, int* out_cols) {
  // convert to min-cost
  std::vector<double> u(t + 1, 0.0), v(n + 1, 0.0);
  std::vector<int> p(n + 1, 0);   // p[j] = row matched to column j (1-based)
  std::vector<int> way(n + 1, 0);
  for (int i = 1; i <= t; ++i) {
    p[0] = i;
    int j0 = 0;
    std::vector<double> minv(n + 1, INF);
    std::vector<char> used(n + 1, false);
    do {
      used[j0] = true;
      int i0 = p[j0], j1 = -1;
      double delta = INF;
      for (int j = 1; j <= n; ++j) {
        if (used[j]) continue;
        double cur = -score[(i0 - 1) * n + (j - 1)] - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      for (int j = 0; j <= n; ++j) {
        if (used[j]) {
          u[p[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (p[j0] != 0);
    do {
      int j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    } while (j0);
  }
  for (int i = 0; i < t; ++i) out_cols[i] = -1;
  for (int j = 1; j <= n; ++j)
    if (p[j] > 0) out_cols[p[j] - 1] = j - 1;
}

}  // extern "C"
