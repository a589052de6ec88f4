/* Connected components of a binary mask on the host, with cv2's stats:
 * the three functions of the JAX package's native/maskops.cpp in C, for
 * utils/native.py. The algorithm is that file's, step for step, so the
 * labels are its labels:
 *
 *   maskops_label          two-pass union-find: a pixel takes the least
 *                          provisional label of its already-visited
 *                          neighbours (up, left; and up-left, up-right at
 *                          connectivity 8) and unites them, the smaller
 *                          root winning; then roots are numbered 1.. in
 *                          raster order of their first pixel; stats rows
 *                          are [left, top, width, height, area] (cv2's
 *                          CC_STAT_* layout), row 0 the background
 *   maskops_filter_area    zero every component of area <= min_area
 *   maskops_keep_largest   keep the largest component (the first label
 *                          on a tie); where it is smaller than
 *                          min_keep_area keep every component larger than
 *                          fallback_min_area instead
 *
 * The mask is h*w bytes, nonzero the foreground; the filters rewrite it
 * in place as {0, 255}. maskops_label returns the number of labels with
 * the background, -1 where there are more than max_labels, -2 where memory
 * runs out; the filters return the components kept, or those codes. Built
 * by ops/kernels/build.py with the host compiler, called through ctypes.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define MASKOPS_ETOOMANY -1
#define MASKOPS_ENOMEM -2

static int32_t find_root(int32_t *parent, int32_t x) {
  while (parent[x] != x) {
    parent[x] = parent[parent[x]]; /* path halving */
    x = parent[x];
  }
  return x;
}

static void unite(int32_t *parent, int32_t a, int32_t b) {
  a = find_root(parent, a);
  b = find_root(parent, b);
  if (a == b) return;
  if (a < b)
    parent[b] = a; /* the smaller root wins */
  else
    parent[a] = b;
}

int32_t maskops_label(const uint8_t *mask, int32_t h, int32_t w,
                      int32_t connectivity, int32_t *labels, int32_t *stats,
                      int32_t max_labels) {
  const int64_t n = (int64_t)h * w;
  int32_t *parent = malloc(sizeof(int32_t) * (size_t)(n + 1));
  int32_t *prov = malloc(sizeof(int32_t) * (size_t)(n + 1));
  int32_t *remap = NULL, *minx = NULL, *miny = NULL, *maxx = NULL,
          *maxy = NULL, *area = NULL;
  int32_t next = 0, count = 1, rc;
  if (!parent || !prov) {
    rc = MASKOPS_ENOMEM;
    goto done;
  }
  for (int32_t y = 0; y < h; ++y) {
    for (int32_t x = 0; x < w; ++x) {
      const int64_t i = (int64_t)y * w + x;
      int32_t cand[4] = {-1, -1, -1, -1}, lbl = -1;
      prov[i] = -1;
      if (!mask[i]) continue;
      if (y > 0 && mask[i - w]) cand[0] = prov[i - w];
      if (x > 0 && mask[i - 1]) cand[1] = prov[i - 1];
      if (connectivity == 8 && y > 0) {
        if (x > 0 && mask[i - w - 1]) cand[2] = prov[i - w - 1];
        if (x + 1 < w && mask[i - w + 1]) cand[3] = prov[i - w + 1];
      }
      for (int k = 0; k < 4; ++k)
        if (cand[k] >= 0 && (lbl < 0 || cand[k] < lbl)) lbl = cand[k];
      if (lbl < 0) {
        lbl = next++;
        parent[lbl] = lbl;
      } else {
        for (int k = 0; k < 4; ++k)
          if (cand[k] >= 0) unite(parent, lbl, cand[k]);
      }
      prov[i] = lbl;
    }
  }
  /* roots → final labels in raster order of their first pixel */
  remap = calloc((size_t)next + 1, sizeof(int32_t));
  if (!remap) {
    rc = MASKOPS_ENOMEM;
    goto done;
  }
  for (int64_t i = 0; i < n; ++i) {
    if (prov[i] < 0) {
      labels[i] = 0;
      continue;
    }
    int32_t root = find_root(parent, prov[i]);
    if (remap[root] == 0) {
      if (count >= max_labels) {
        rc = MASKOPS_ETOOMANY;
        goto done;
      }
      remap[root] = count++;
    }
    labels[i] = remap[root];
  }
  minx = malloc(sizeof(int32_t) * (size_t)count);
  miny = malloc(sizeof(int32_t) * (size_t)count);
  maxx = malloc(sizeof(int32_t) * (size_t)count);
  maxy = malloc(sizeof(int32_t) * (size_t)count);
  area = calloc((size_t)count, sizeof(int32_t));
  if (!minx || !miny || !maxx || !maxy || !area) {
    rc = MASKOPS_ENOMEM;
    goto done;
  }
  for (int32_t l = 0; l < count; ++l) {
    minx[l] = w;
    miny[l] = h;
    maxx[l] = -1;
    maxy[l] = -1;
  }
  for (int32_t y = 0; y < h; ++y) {
    for (int32_t x = 0; x < w; ++x) {
      const int32_t l = labels[(int64_t)y * w + x];
      area[l] += 1;
      if (x < minx[l]) minx[l] = x;
      if (y < miny[l]) miny[l] = y;
      if (x > maxx[l]) maxx[l] = x;
      if (y > maxy[l]) maxy[l] = y;
    }
  }
  memset(stats, 0, sizeof(int32_t) * 5 * (size_t)count);
  for (int32_t l = 0; l < count; ++l) {
    int32_t *row = stats + (int64_t)l * 5;
    if (area[l] > 0) {
      row[0] = minx[l];
      row[1] = miny[l];
      row[2] = maxx[l] - minx[l] + 1;
      row[3] = maxy[l] - miny[l] + 1;
      row[4] = area[l];
    }
  }
  rc = count;
done:
  free(parent);
  free(prov);
  free(remap);
  free(minx);
  free(miny);
  free(maxx);
  free(maxy);
  free(area);
  return rc;
}

/* Label `mask`, then rewrite it as 255 where keep[label] and 0 elsewhere.
 * choose(stats, count, keep, arg_a, arg_b) fills keep[1..count-1]. */
typedef void (*chooser)(const int32_t *, int32_t, uint8_t *, int32_t,
                        int32_t);

static int32_t relabel(uint8_t *mask, int32_t h, int32_t w,
                       int32_t connectivity, chooser choose, int32_t a,
                       int32_t b) {
  const int64_t n = (int64_t)h * w;
  const int32_t max_labels = (int32_t)(n / 2 + 2);
  int32_t *labels = malloc(sizeof(int32_t) * (size_t)(n + 1));
  int32_t *stats = malloc(sizeof(int32_t) * 5 * (size_t)max_labels);
  uint8_t *keep = NULL;
  int32_t count, kept = 0;
  if (!labels || !stats) {
    count = MASKOPS_ENOMEM;
    goto done;
  }
  count = maskops_label(mask, h, w, connectivity, labels, stats, max_labels);
  if (count < 0) goto done;
  keep = calloc((size_t)count, 1);
  if (!keep) {
    count = MASKOPS_ENOMEM;
    goto done;
  }
  if (count > 1) choose(stats, count, keep, a, b);
  for (int32_t l = 1; l < count; ++l) kept += keep[l];
  for (int64_t i = 0; i < n; ++i) mask[i] = keep[labels[i]] ? 255 : 0;
done:
  free(labels);
  free(stats);
  free(keep);
  return count < 0 ? count : kept;
}

static void above_area(const int32_t *stats, int32_t count, uint8_t *keep,
                       int32_t min_area, int32_t unused) {
  (void)unused;
  for (int32_t l = 1; l < count; ++l)
    keep[l] = stats[(int64_t)l * 5 + 4] > min_area;
}

static void largest_rule(const int32_t *stats, int32_t count, uint8_t *keep,
                         int32_t min_keep_area, int32_t fallback_min_area) {
  int32_t largest = 1;
  for (int32_t l = 2; l < count; ++l)
    if (stats[(int64_t)l * 5 + 4] > stats[(int64_t)largest * 5 + 4])
      largest = l;
  if (stats[(int64_t)largest * 5 + 4] >= min_keep_area)
    keep[largest] = 1;
  else
    above_area(stats, count, keep, fallback_min_area, 0);
}

int32_t maskops_filter_area(uint8_t *mask, int32_t h, int32_t w,
                            int32_t connectivity, int32_t min_area) {
  return relabel(mask, h, w, connectivity, above_area, min_area, 0);
}

int32_t maskops_keep_largest(uint8_t *mask, int32_t h, int32_t w,
                             int32_t connectivity, int32_t min_keep_area,
                             int32_t fallback_min_area) {
  return relabel(mask, h, w, connectivity, largest_rule, min_keep_area,
                 fallback_min_area);
}
