// In-memory slot-record dataset: parallel text parse, shuffle, CSR batches.
//
// TPU-native rebuild of the reference's industrial feed pipeline:
//   - SlotRecordInMemoryDataFeed text parsing
//     (paddle/fluid/framework/data_feed.h:978,1615 / data_feed.cc)
//   - DatasetImpl/MultiSlotDataset in-memory channels + shuffle
//     (paddle/fluid/framework/data_set.h:49,180,350)
// The reference streams records through lock-guarded channels into
// per-thread DataFeeds; on TPU one host process feeds all local chips, so
// the equivalent structure is: parse files on host threads into a flat
// record store, shuffle indices, emit CSR batches that Python pads to
// static shapes (SURVEY.md §7 bucketing strategy).
//
// Text format (MultiSlotDataFeed-style, tab separated):
//   <label>\t<slot_id>:<sign>[,<sign>...]\t<slot_id>:<sign>[,...]...
// Unknown slots are ignored; missing slots yield empty feature lists.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include "common.h"

namespace {

struct SlotFeed {
  explicit SlotFeed(std::vector<int64_t> slot_ids) : slots(std::move(slot_ids)) {
    for (size_t i = 0; i < slots.size(); ++i) slot_index[slots[i]] = i;
  }

  std::vector<int64_t> slots;
  std::unordered_map<int64_t, size_t> slot_index;

  // Record storage: per slot, CSR over records.
  // signs[s] holds all feature signs of slot s; offs[s][r..r+1] delimit
  // record r's span. labels[r] is the click/label.
  std::vector<std::vector<int64_t>> signs;
  std::vector<std::vector<int64_t>> offs;  // length records+1 per slot
  std::vector<float> labels;
  std::vector<int64_t> order;              // shuffle permutation

  int64_t NumRecords() const { return static_cast<int64_t>(labels.size()); }
};

bool ParseLine(const char* line, size_t len, const SlotFeed& feed,
               float* label, std::vector<std::vector<int64_t>>& slot_signs) {
  for (auto& v : slot_signs) v.clear();
  // Lines are slices of one shared buffer, so they are NOT NUL-terminated:
  // strtof/strtoll whitespace skipping includes '\n' and would silently run
  // into the NEXT line on a truncated record. Every parse must be checked
  // against `end` — consuming past the slice is a malformed line, not a
  // continuation.
  const char* p = line;
  const char* end = line + len;
  char* next = nullptr;
  *label = std::strtof(p, &next);
  if (next == p || next > end) return false;
  p = next;
  while (p < end && *p != '\0') {
    while (p < end && (*p == '\t' || *p == ' ')) ++p;
    if (p >= end || *p == '\0' || *p == '\n') break;
    int64_t slot = std::strtoll(p, &next, 10);
    if (next == p || next >= end || *next != ':') return false;
    p = next + 1;
    auto it = feed.slot_index.find(slot);
    const bool keep = it != feed.slot_index.end();
    while (true) {
      if (p >= end) return false;  // 'slot:' with no sign before line end
      int64_t sign = std::strtoll(p, &next, 10);
      if (next == p || next > end) return false;
      if (keep) slot_signs[it->second].push_back(sign);
      p = next;
      if (p < end && *p == ',') {
        ++p;
        continue;
      }
      break;
    }
  }
  return true;
}

}  // namespace

extern "C" {

void* pt_feed_create(const int64_t* slot_ids, int64_t n_slots) {
  auto* f = new SlotFeed(std::vector<int64_t>(slot_ids, slot_ids + n_slots));
  f->signs.resize(n_slots);
  f->offs.assign(n_slots, std::vector<int64_t>{0});
  return f;
}

void pt_feed_destroy(void* h) { delete static_cast<SlotFeed*>(h); }

// Parse a whole file; returns records added, or -1 on IO error, -2 on a
// malformed line (parsing stops there; prior records are kept).
int64_t pt_feed_load_file(void* h, const char* path) {
  auto* f = static_cast<SlotFeed*>(h);
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  std::fseek(fp, 0, SEEK_END);
  long size = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  std::string buf(static_cast<size_t>(size), '\0');
  if (size > 0 && std::fread(&buf[0], 1, size, fp) != static_cast<size_t>(size)) {
    std::fclose(fp);
    return -1;
  }
  std::fclose(fp);

  // Split lines; parse in parallel chunks into thread-local stores, then
  // splice (the reference's multi-thread DataFeed -> channel merge).
  std::vector<std::pair<const char*, size_t>> lines;
  size_t start = 0;
  for (size_t i = 0; i <= buf.size(); ++i) {
    if (i == buf.size() || buf[i] == '\n') {
      if (i > start) lines.emplace_back(buf.data() + start, i - start);
      start = i + 1;
    }
  }
  const size_t n_slots = f->slots.size();
  struct Local {
    std::vector<float> labels;
    std::vector<std::vector<int64_t>> signs, offs;
    bool bad = false;
  };
  size_t workers = std::max<size_t>(1, std::thread::hardware_concurrency());
  workers = std::min(workers, std::max<size_t>(1, lines.size() / 1024 + 1));
  std::vector<Local> locals(workers);
  size_t per = (lines.size() + workers - 1) / workers;
  std::vector<std::thread> threads;
  for (size_t w = 0; w < workers; ++w) {
    threads.emplace_back([&, w] {
      Local& loc = locals[w];
      loc.signs.resize(n_slots);
      loc.offs.assign(n_slots, std::vector<int64_t>{0});
      std::vector<std::vector<int64_t>> tmp(n_slots);
      float label;
      size_t lo = w * per, hi = std::min(lines.size(), lo + per);
      for (size_t i = lo; i < hi; ++i) {
        if (!ParseLine(lines[i].first, lines[i].second, *f, &label, tmp)) {
          loc.bad = true;
          return;
        }
        loc.labels.push_back(label);
        for (size_t s = 0; s < n_slots; ++s) {
          loc.signs[s].insert(loc.signs[s].end(), tmp[s].begin(), tmp[s].end());
          loc.offs[s].push_back(static_cast<int64_t>(loc.signs[s].size()));
        }
      }
    });
  }
  for (auto& t : threads) t.join();

  int64_t added = 0;
  for (auto& loc : locals) {
    if (loc.bad) return -2;
    if (loc.labels.empty()) continue;
    f->labels.insert(f->labels.end(), loc.labels.begin(), loc.labels.end());
    for (size_t s = 0; s < n_slots; ++s) {
      const int64_t base = f->signs[s].size();
      f->signs[s].insert(f->signs[s].end(), loc.signs[s].begin(),
                         loc.signs[s].end());
      // skip the leading 0 of the local offsets
      for (size_t r = 1; r < loc.offs[s].size(); ++r) {
        f->offs[s].push_back(base + loc.offs[s][r]);
      }
    }
    added += static_cast<int64_t>(loc.labels.size());
  }
  f->order.resize(f->labels.size());
  for (size_t i = 0; i < f->order.size(); ++i) f->order[i] = i;
  return added;
}

int64_t pt_feed_num_records(void* h) {
  return static_cast<SlotFeed*>(h)->NumRecords();
}

void pt_feed_shuffle(void* h, uint64_t seed) {
  auto* f = static_cast<SlotFeed*>(h);
  ptn::XorShift128 rng(seed);
  for (size_t i = f->order.size(); i > 1; --i) {
    std::swap(f->order[i - 1], f->order[rng.bounded(i)]);
  }
}

void pt_feed_clear(void* h) {
  auto* f = static_cast<SlotFeed*>(h);
  for (auto& s : f->signs) s.clear();
  for (auto& o : f->offs) o.assign(1, 0);
  f->labels.clear();
  f->order.clear();
}

// Extract batch [start, start+bs) (in shuffled order) for one slot.
// out_signs buffer must hold >= bs * max_per_slot entries; per-record
// signs are truncated to max_per_slot and padded with pad_value.
// out_counts[r] = actual (untruncated-capped) count.
void pt_feed_batch_slot(void* h, int64_t start, int64_t bs, int64_t slot_idx,
                        int64_t max_per_slot, int64_t pad_value,
                        int64_t* out_signs, int32_t* out_counts) {
  auto* f = static_cast<SlotFeed*>(h);
  const auto& signs = f->signs[slot_idx];
  const auto& offs = f->offs[slot_idx];
  for (int64_t r = 0; r < bs; ++r) {
    int64_t* row = out_signs + r * max_per_slot;
    std::fill(row, row + max_per_slot, pad_value);
    const int64_t rec = f->order[start + r];
    const int64_t beg = offs[rec], end = offs[rec + 1];
    const int64_t n = std::min<int64_t>(end - beg, max_per_slot);
    std::copy(signs.begin() + beg, signs.begin() + beg + n, row);
    out_counts[r] = static_cast<int32_t>(n);
  }
}

void pt_feed_batch_labels(void* h, int64_t start, int64_t bs, float* out) {
  auto* f = static_cast<SlotFeed*>(h);
  for (int64_t r = 0; r < bs; ++r) out[r] = f->labels[f->order[start + r]];
}
}
