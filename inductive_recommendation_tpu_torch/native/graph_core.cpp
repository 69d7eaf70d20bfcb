// Native graph-core routines: the host-side hot spots of data preparation.
// The port's own copy of inductive_recommendation_tpu/native/graph_core.cpp,
// the same source.
//
// The reference delegates all native work to libraries (DGL/cuBLAS) and runs
// its own data prep in pure python — k-core filtering over millions of raw
// interactions (dataset.py:66-92) is minutes of dict loops. These routines
// are exposed through a plain C ABI for ctypes.
//
// Build: see native/__init__.py (g++ -O3 -shared -fPIC, into native/build/).

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// Iterative k-core peeling over a deduplicated bipartite edge list.
// Inputs: edges (users[e], items[e]) with dense ids; outputs keep flags.
// Semantics match dataset.py:66-92: repeatedly drop users/items whose
// remaining degree < min_inter until a fixed point (the k-core is unique,
// so any peeling order yields the reference's surviving set).
void kcore(const int64_t* users, const int64_t* items, int64_t n_edges,
           int64_t n_users, int64_t n_items, int64_t min_inter,
           uint8_t* keep_users, uint8_t* keep_items) {
  std::vector<int64_t> u_deg(n_users, 0), i_deg(n_items, 0);
  for (int64_t e = 0; e < n_edges; ++e) {
    u_deg[users[e]]++;
    i_deg[items[e]]++;
  }
  // CSR over both sides for O(deg) neighbor walks during peeling
  std::vector<int64_t> u_off(n_users + 1, 0), i_off(n_items + 1, 0);
  for (int64_t u = 0; u < n_users; ++u) u_off[u + 1] = u_off[u] + u_deg[u];
  for (int64_t i = 0; i < n_items; ++i) i_off[i + 1] = i_off[i] + i_deg[i];
  std::vector<int64_t> u_adj(n_edges), i_adj(n_edges);
  {
    std::vector<int64_t> ucur(u_off.begin(), u_off.end() - 1);
    std::vector<int64_t> icur(i_off.begin(), i_off.end() - 1);
    for (int64_t e = 0; e < n_edges; ++e) {
      u_adj[ucur[users[e]]++] = items[e];
      i_adj[icur[items[e]]++] = users[e];
    }
  }
  std::memset(keep_users, 1, n_users);
  std::memset(keep_items, 1, n_items);
  std::vector<int64_t> queue;
  queue.reserve(n_users + n_items);
  // encode: user u -> u, item i -> n_users + i
  for (int64_t u = 0; u < n_users; ++u)
    if (u_deg[u] < min_inter) { keep_users[u] = 0; queue.push_back(u); }
  for (int64_t i = 0; i < n_items; ++i)
    if (i_deg[i] < min_inter) { keep_items[i] = 0; queue.push_back(n_users + i); }
  for (size_t qi = 0; qi < queue.size(); ++qi) {
    int64_t node = queue[qi];
    if (node < n_users) {
      int64_t u = node;
      for (int64_t p = u_off[u]; p < u_off[u + 1]; ++p) {
        int64_t i = u_adj[p];
        if (keep_items[i] && --i_deg[i] < min_inter) {
          keep_items[i] = 0;
          queue.push_back(n_users + i);
        }
      }
    } else {
      int64_t i = node - n_users;
      for (int64_t p = i_off[i]; p < i_off[i + 1]; ++p) {
        int64_t u = i_adj[p];
        if (keep_users[u] && --u_deg[u] < min_inter) {
          keep_users[u] = 0;
          queue.push_back(u);
        }
      }
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Raw-file parsers: the host-side data-loading hot spots.
//
// The reference parses Gowalla_totalCheckins.txt with a python
// time.strptime per line (dataset.py:183-186) — ~10-20us/line, minutes at
// the 6.4M-line full file. These parse the fixed formats directly.
// Timestamps are UTC epoch seconds (days-from-civil; the reference's
// time.mktime depended on the host timezone — ordering, the only thing the
// chronological split consumes, is unchanged).

#include <cstdio>

namespace {

inline int64_t days_from_civil(int64_t y, int64_t m, int64_t d) {
  y -= m <= 2;
  const int64_t era = (y >= 0 ? y : y - 399) / 400;
  const int64_t yoe = y - era * 400;
  const int64_t doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
  const int64_t doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097 + doe - 719468;
}

inline const char* parse_int(const char* p, const char* end, int64_t* out) {
  int64_t v = 0;
  bool neg = false, any = false;
  if (p < end && *p == '-') { neg = true; ++p; }
  while (p < end && *p >= '0' && *p <= '9') { v = v * 10 + (*p - '0'); ++p; any = true; }
  if (!any) return nullptr;
  *out = neg ? -v : v;
  return p;
}

inline bool all_digits(const char* p, int n) {
  for (int k = 0; k < n; ++k)
    if (p[k] < '0' || p[k] > '9') return false;
  return true;
}

inline int64_t fixed_digits(const char* p, int n) {
  int64_t v = 0;
  for (int k = 0; k < n; ++k) v = v * 10 + (p[k] - '0');
  return v;
}

// validates "%Y-%m-%dT%H:%M:%SZ" (20 chars): digit fields + separators —
// corrupt content must fail loudly, as the reference's strptime did
inline bool valid_iso8601z(const char* p) {
  return all_digits(p, 4) && p[4] == '-' && all_digits(p + 5, 2) &&
         p[7] == '-' && all_digits(p + 8, 2) && p[10] == 'T' &&
         all_digits(p + 11, 2) && p[13] == ':' && all_digits(p + 14, 2) &&
         p[16] == ':' && all_digits(p + 17, 2) && p[19] == 'Z';
}

std::vector<char> read_all(const char* path) {
  std::vector<char> buf;
  FILE* f = std::fopen(path, "rb");
  if (!f) return buf;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf.resize(sz);
  if (sz && std::fread(buf.data(), 1, sz, f) != (size_t)sz) buf.clear();
  std::fclose(f);
  return buf;
}

}  // namespace

extern "C" {

// Gowalla_totalCheckins.txt: "user \t %Y-%m-%dT%H:%M:%SZ \t lat \t lon \t item".
// Fills users/items/ts; returns rows parsed, -1 on open failure, -2 on a
// malformed line or capacity overflow.
int64_t parse_gowalla(const char* path, int64_t cap, int64_t* users,
                      int64_t* items, int64_t* ts) {
  std::vector<char> buf = read_all(path);
  if (buf.empty()) return -1;
  const char* p = buf.data();
  const char* end = p + buf.size();
  int64_t n = 0;
  while (p < end) {
    while (p < end && (*p == '\n' || *p == '\r')) ++p;
    if (p >= end) break;
    if (n >= cap) return -2;
    int64_t u;
    p = parse_int(p, end, &u);
    if (!p || p >= end || *p != '\t') return -2;
    ++p;
    // fixed-width %Y-%m-%dT%H:%M:%SZ (20 chars), content-validated
    if (end - p < 20 || !valid_iso8601z(p)) return -2;
    const int64_t y = fixed_digits(p, 4), mo = fixed_digits(p + 5, 2),
                  d = fixed_digits(p + 8, 2), h = fixed_digits(p + 11, 2),
                  mi = fixed_digits(p + 14, 2), s = fixed_digits(p + 17, 2);
    p += 20;
    if (p >= end || *p != '\t') return -2;
    ++p;
    for (int skip = 0; skip < 2; ++skip) {  // lat, lon
      while (p < end && *p != '\t') ++p;
      if (p >= end) return -2;
      ++p;
    }
    int64_t i;
    p = parse_int(p, end, &i);
    if (!p) return -2;
    // ANY trailing content after the item id must fail: the reference
    // tab-splits and calls int() on the whole 5th field, so "123 junk"
    // raises there — exempting spaces/tabs would silently accept it here
    if (p < end && *p != '\n' && *p != '\r') return -2;
    users[n] = u;
    items[n] = i;
    ts[n] = days_from_civil(y, mo, d) * 86400 + h * 3600 + mi * 60 + s;
    ++n;
    while (p < end && *p != '\n') ++p;
  }
  return n;
}

// yelp_academic_dataset_review.json: one JSON object per line; the framework
// consumes (user_id, business_id, stars, date) and keeps stars > 3
// (reference dataset.py:192-225). String ids are interned to dense int64 in
// first-seen order — downstream only ever re-maps them (remove_sparse_ui),
// so interning is parity-preserving. The reference json.loads's per-line
// decode is the load-time hot spot at the ~7M-line full file.
//
// Field extraction is positional-scanning, NOT a JSON parser: user_id /
// business_id / stars are taken at their FIRST occurrence (they precede the
// free-text "text" field in the dataset), "date" at its LAST (it follows
// it). Every extracted value is format-validated; anything surprising —
// escapes in an id, a malformed date, a missing key — returns -2 so the
// caller falls back to the exact python json path.
int64_t parse_yelp(const char* path, int64_t cap, int64_t* users,
                   int64_t* items, int64_t* ts, int64_t* n_distinct_users,
                   int64_t* n_distinct_items) {
  std::vector<char> buf = read_all(path);
  if (buf.empty()) return -1;
  std::unordered_map<std::string, int64_t> umap, imap;
  const char* p = buf.data();
  const char* end = p + buf.size();
  int64_t n = 0;
  auto find = [](const char* a, const char* b, const char* pat,
                 bool last) -> const char* {
    size_t m = std::strlen(pat);
    const char* hit = nullptr;
    for (const char* q = a; q + (long)m <= b; ++q) {
      if (std::memcmp(q, pat, m) == 0) {
        hit = q + m;
        if (!last) return hit;
      }
    }
    return hit;
  };
  while (p < end) {
    const char* le = p;
    while (le < end && *le != '\n') ++le;
    bool blank = true;
    for (const char* q = p; q < le; ++q)
      if (*q != ' ' && *q != '\t' && *q != '\r') { blank = false; break; }
    if (!blank) {
      const char* up = find(p, le, "\"user_id\":\"", false);
      const char* bp = find(p, le, "\"business_id\":\"", false);
      const char* sp = find(p, le, "\"stars\":", false);
      const char* dp = find(p, le, "\"date\":\"", true);
      if (!up || !bp || !sp || !dp) return -2;
      auto read_id = [&](const char* q, std::string* out) -> bool {
        const char* s = q;
        while (q < le && *q != '"' && *q != '\\') ++q;
        if (q >= le || *q != '"' || q == s) return false;  // escape/empty: bail
        out->assign(s, q - s);
        return true;
      };
      std::string uid, bid;
      if (!read_id(up, &uid) || !read_id(bp, &bid)) return -2;
      // stars: number (e.g. 5.0 / 4); keep if > 3.0
      const char* q = sp;
      while (q < le && *q == ' ') ++q;
      int64_t ip = 0;
      const char* q2 = parse_int(q, le, &ip);
      if (!q2) return -2;
      double stars = (double)ip;
      if (q2 < le && *q2 == '.') {
        ++q2;
        double f = 0.1;
        while (q2 < le && *q2 >= '0' && *q2 <= '9') {
          stars += (*q2 - '0') * f;
          f *= 0.1;
          ++q2;
        }
      }
      if (stars > 3.0) {
        // date: "%Y-%m-%d %H:%M:%S" (19 chars) + closing quote
        if (le - dp < 20 || !all_digits(dp, 4) || dp[4] != '-' ||
            !all_digits(dp + 5, 2) || dp[7] != '-' || !all_digits(dp + 8, 2) ||
            dp[10] != ' ' || !all_digits(dp + 11, 2) || dp[13] != ':' ||
            !all_digits(dp + 14, 2) || dp[16] != ':' ||
            !all_digits(dp + 17, 2) || dp[19] != '"')
          return -2;
        if (n >= cap) return -2;
        auto intern = [](std::unordered_map<std::string, int64_t>& m,
                         std::string& k) {
          auto it = m.find(k);
          if (it != m.end()) return it->second;
          int64_t id = (int64_t)m.size();
          m.emplace(std::move(k), id);
          return id;
        };
        users[n] = intern(umap, uid);
        items[n] = intern(imap, bid);
        const int64_t y = fixed_digits(dp, 4), mo = fixed_digits(dp + 5, 2),
                      d = fixed_digits(dp + 8, 2), h = fixed_digits(dp + 11, 2),
                      mi = fixed_digits(dp + 14, 2), s = fixed_digits(dp + 17, 2);
        ts[n] = days_from_civil(y, mo, d) * 86400 + h * 3600 + mi * 60 + s;
        ++n;
      }
    }
    p = (le < end) ? le + 1 : le;
  }
  *n_distinct_users = (int64_t)umap.size();
  *n_distinct_items = (int64_t)imap.size();
  return n;
}

// ratings_Books.csv: "user,item,rating,timestamp"; keep rating > 3
// (reference dataset.py:228-255). Same interning contract as parse_yelp.
int64_t parse_amazon(const char* path, int64_t cap, int64_t* users,
                     int64_t* items, int64_t* ts, int64_t* n_distinct_users,
                     int64_t* n_distinct_items) {
  std::vector<char> buf = read_all(path);
  if (buf.empty()) return -1;
  std::unordered_map<std::string, int64_t> umap, imap;
  const char* p = buf.data();
  const char* end = p + buf.size();
  int64_t n = 0;
  while (p < end) {
    const char* le = p;
    while (le < end && *le != '\n') ++le;
    const char* lstop = le;
    while (lstop > p && (lstop[-1] == '\r' || lstop[-1] == ' ' ||
                         lstop[-1] == '\t'))
      --lstop;
    if (lstop > p) {
      // exactly 4 comma-separated fields, as the reference's split(',')
      // 4-way unpack requires (a 5th comma raises there)
      const char* c1 = p;
      while (c1 < lstop && *c1 != ',') ++c1;
      const char* c2 = c1 + 1;
      while (c2 < lstop && *c2 != ',') ++c2;
      const char* c3 = c2 + 1;
      while (c3 < lstop && *c3 != ',') ++c3;
      if (c1 >= lstop || c2 >= lstop || c3 >= lstop || c1 == p || c2 == c1 + 1)
        return -2;
      for (const char* q = c3 + 1; q < lstop; ++q)
        if (*q == ',') return -2;
      // rating: float text
      const char* q = c2 + 1;
      int64_t ip = 0;
      const char* q2 = parse_int(q, c3, &ip);
      if (!q2) return -2;
      double rating = (double)ip;
      if (q2 < c3 && *q2 == '.') {
        ++q2;
        double f = 0.1;
        while (q2 < c3 && *q2 >= '0' && *q2 <= '9') {
          rating += (*q2 - '0') * f;
          f *= 0.1;
          ++q2;
        }
      }
      if (q2 != c3) return -2;
      if (rating > 3.0) {
        int64_t t;
        const char* q3 = parse_int(c3 + 1, lstop, &t);
        if (!q3 || q3 != lstop) return -2;
        if (n >= cap) return -2;
        std::string uid(p, c1 - p), bid(c1 + 1, c2 - c1 - 1);
        auto intern = [](std::unordered_map<std::string, int64_t>& m,
                         std::string& k) {
          auto it = m.find(k);
          if (it != m.end()) return it->second;
          int64_t id = (int64_t)m.size();
          m.emplace(std::move(k), id);
          return id;
        };
        users[n] = intern(umap, uid);
        items[n] = intern(imap, bid);
        ts[n] = t;
        ++n;
      }
    }
    p = (le < end) ? le + 1 : le;
  }
  *n_distinct_users = (int64_t)umap.size();
  *n_distinct_items = (int64_t)imap.size();
  return n;
}

// "user item item ..." adjacency text (ProcessedDataset train/val/test.txt,
// dataset.py:140-164). Fills the flat item stream (first token of each line
// — the user id — is DISCARDED; line order is the user id, as in the
// reference) and per-line offsets; returns the line count, -1/-2 as above.
int64_t parse_adjacency(const char* path, int64_t cap_items,
                        int64_t cap_lines, int64_t* flat_items,
                        int64_t* offsets) {
  std::vector<char> buf = read_all(path);
  if (buf.empty()) return -1;
  const char* p = buf.data();
  const char* end = p + buf.size();
  // match the python fallback's read().strip().split('\n') exactly:
  // leading/trailing blank lines are dropped, INTERIOR blank lines are
  // EMPTY ROWS (line order is the user id — skipping them would shift
  // every later user's list onto the wrong user, silent corruption)
  while (p < end &&
         (*p == '\n' || *p == '\r' || *p == ' ' || *p == '\t'))
    ++p;
  int64_t n_lines = 0, n_items = 0, pending_blank = 0;
  while (p < end) {
    const char* le = p;
    while (le < end && *le != '\n') ++le;
    bool blank = true;
    for (const char* q = p; q < le; ++q) {
      if (*q != ' ' && *q != '\t' && *q != '\r') {
        blank = false;
        break;
      }
    }
    if (blank) {
      ++pending_blank;  // emitted only if a non-blank line follows
    } else {
      // strictness guards: the fallback splits on SINGLE SPACES, so a line
      // with leading whitespace discards an EMPTY first token (every numeric
      // token is then an item), and a tab inside a token makes int() raise.
      // Both cases must fail over to the fallback's exact semantics rather
      // than silently re-interpreting the line here.
      if (*p == ' ' || *p == '\t') return -2;
      for (const char* q = p; q < le; ++q)
        if (*q == '\t') return -2;
      for (; pending_blank > 0; --pending_blank) {
        if (n_lines >= cap_lines) return -2;
        offsets[n_lines++] = n_items;
      }
      if (n_lines >= cap_lines) return -2;
      offsets[n_lines] = n_items;
      const char* q = p;
      bool first = true;
      while (q < le) {
        if (*q == ' ' || *q == '\r') {
          ++q;
          continue;
        }
        int64_t v;
        q = parse_int(q, le, &v);
        if (!q) return -2;
        if (first) {
          first = false;  // user id token: discarded
        } else {
          if (n_items >= cap_items) return -2;
          flat_items[n_items++] = v;
        }
      }
      ++n_lines;
    }
    p = (le < end) ? le + 1 : le;
  }
  offsets[n_lines] = n_items;
  return n_lines;
}

}  // extern "C"
