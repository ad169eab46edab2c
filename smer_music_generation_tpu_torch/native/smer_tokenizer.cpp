// SMER tokenizer core: per-bar note gridding + chord grouping + duration
// snapping, the hot loop of the bulk MIDI->SMER dataset build.
//
// The reference performs this per-note work in Python
// (encode.py:900-1141 grid_notes / bar_notes_to_event); this native core
// implements the same semantics (including the framework's documented
// divergences: deleted zero-length notes are dropped, the trailing flush
// uses continue-first ordering) behind a C ABI consumed via ctypes.
//
// Token stream encoding (int32):
//   -1 = rest, -2 = sep, -3 = continue
//   1000 + midi_pitch   = pitch token
//   2000 + table_index  = duration-table entry (caller expands to parts)
//
// Copy of smer_music_generation_tpu/native/smer_tokenizer.cpp for the
// PyTorch port.  native/__init__.py builds it at first use with
//   g++ -O3 -shared -fPIC -std=c++17 -o build/native/libsmer_tokenizer_<hash>.so \
//       smer_tokenizer.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Note {
  double start;
  double end;
  int pitch;
  int velocity;  // -1 marks a continuation note
};

int snap_duration(double d, const double* times, int n_times) {
  int best = 0;
  double best_diff = std::abs(d - times[0]);
  for (int i = 1; i < n_times; ++i) {
    double diff = std::abs(d - times[i]);
    if (diff < best_diff) {
      best_diff = diff;
      best = i;
    }
  }
  return best;
}

struct Emitter {
  int32_t* out;
  int max_out;
  int n = 0;
  bool overflow = false;

  void push(int32_t code) {
    if (n < max_out) {
      out[n++] = code;
    } else {
      overflow = true;
    }
  }
};

struct ContinueOut {
  int32_t* pitches;
  double* ends;
  int max_n;
  int n = 0;

  void add(int pitch, double end) {
    if (n < max_n) {
      // reference semantics: dict keyed by pitch -> later wins
      for (int i = 0; i < n; ++i) {
        if (pitches[i] == pitch) {
          ends[i] = end;
          return;
        }
      }
      pitches[n] = pitch;
      ends[n] = end;
      ++n;
    }
  }
};

// zero_index: table index whose entry is the 'zero' duration (emits nothing)
void emit_duration(Emitter& em, double d, const double* times, int n_times,
                   int zero_index) {
  int idx = snap_duration(d, times, n_times);
  if (idx == zero_index) return;
  em.push(2000 + idx);
}

bool duration_is_zero(double d, const double* times, int n_times,
                      int zero_index) {
  return snap_duration(d, times, n_times) == zero_index;
}

void flush_chord_group(std::vector<Note>& chord, double next_bar_time,
                       const double* times, int n_times, int zero_index,
                       Emitter& em, ContinueOut& cont_out) {
  // continue-first ordering, each half sorted by pitch
  std::stable_sort(chord.begin(), chord.end(), [](const Note& a, const Note& b) {
    bool ca = a.velocity == -1, cb = b.velocity == -1;
    if (ca != cb) return ca > cb;
    return a.pitch < b.pitch;
  });
  // remove adjacent duplicate pitches, keeping the later entry
  std::vector<Note> dedup;
  for (size_t i = 0; i < chord.size(); ++i) {
    if (i + 1 < chord.size() && chord[i].pitch == chord[i + 1].pitch) continue;
    dedup.push_back(chord[i]);
  }

  auto emit_note = [&](const Note& note) -> double {
    if (note.end > next_bar_time) {
      cont_out.add(note.pitch, note.end);
      return next_bar_time - note.start;
    }
    return note.end - note.start;
  };

  double group_dur = 0.0;
  bool has_cont = false, has_new = false;
  for (const auto& nte : dedup) {
    if (nte.velocity == -1) has_cont = true;
    else has_new = true;
  }

  if (has_cont) {
    em.push(-3);  // continue
    for (const auto& nte : dedup) {
      if (nte.velocity != -1) continue;
      em.push(1000 + nte.pitch);
      group_dur = emit_note(nte);
    }
    if (has_new) {
      emit_duration(em, group_dur, times, n_times, zero_index);
      em.push(-2);  // sep
    }
  }
  if (has_new) {
    for (const auto& nte : dedup) {
      if (nte.velocity == -1) continue;
      em.push(1000 + nte.pitch);
      group_dur = emit_note(nte);
    }
  }
  emit_duration(em, group_dur, times, n_times, zero_index);
}

// Tokenize one bar's note list (carry/continue notes included, marked by
// velocity == -1) into `em`; tie-notes for the next bar go to `cont`.
void tokenize_bar_core(
    std::vector<Note>& notes,
    double bar_time, double next_bar_time,
    const double* beat_times, int n_beats,
    double minimum_difference, int grid_division, int do_grid,
    const double* dur_times, int n_durs, int zero_index,
    Emitter& em, ContinueOut& cont) {
  if (!notes.empty() && do_grid) {
    // build the divided grid (grid_notes, encode.py:900-936)
    std::vector<double> grid;
    grid.reserve((n_beats - 1) * grid_division + 1);
    for (int i = 0; i + 1 < n_beats; ++i) {
      for (int j = 0; j < grid_division; ++j) {
        grid.push_back((beat_times[i + 1] - beat_times[i]) / grid_division * j +
                       beat_times[i]);
      }
    }
    grid.push_back(beat_times[n_beats - 1]);
    const int G = static_cast<int>(grid.size());

    auto nearest = [&](double t) {
      int best = 0;
      double bd = std::abs(t - grid[0]);
      for (int g = 1; g < G; ++g) {
        double d = std::abs(t - grid[g]);
        if (d < bd) {
          bd = d;
          best = g;
        }
      }
      return best;
    };

    for (auto& nte : notes) {
      int sg = nearest(nte.start);
      if (nte.velocity == -1 && nte.end > grid[G - 1]) nte.end = grid[G - 1];
      if (nte.end < grid[G - 1] + minimum_difference) {
        int eg = nearest(nte.end);
        if (sg == eg) {
          if (eg != G - 1) {
            eg += 1;
          } else if (sg != 0) {
            sg -= 1;
          } else {
            nte.start = -1.0;
            nte.end = -1.0;
            continue;
          }
        }
        nte.start = grid[sg];
        nte.end = grid[eg];
      } else {
        nte.start = grid[sg];
      }
    }
    notes.erase(std::remove_if(notes.begin(), notes.end(),
                               [](const Note& x) { return x.start < 0; }),
                notes.end());
    std::stable_sort(notes.begin(), notes.end(), [](const Note& a, const Note& b) {
      if (a.start != b.start) return a.start < b.start;
      if (a.end != b.end) return a.end < b.end;
      return a.pitch < b.pitch;
    });
  }

  double rest_start =
      notes.empty() ? next_bar_time - bar_time : notes[0].start - bar_time;
  if (!duration_is_zero(rest_start, dur_times, n_durs, zero_index)) {
    em.push(-1);
    emit_duration(em, rest_start, dur_times, n_durs, zero_index);
  }

  std::vector<Note> chord;
  for (size_t i = 0; i < notes.size(); ++i) {
    const Note& nte = notes[i];
    if (chord.empty()) {
      chord.push_back(nte);
      continue;
    }
    const Note& last = chord.back();
    bool same_onset = std::abs(nte.start - last.start) < minimum_difference;
    if (nte.end > next_bar_time && same_onset &&
        std::abs(next_bar_time - last.end) < minimum_difference) {
      chord.push_back(nte);
    } else if (same_onset && std::abs(nte.end - last.end) < minimum_difference) {
      chord.push_back(nte);
    } else {
      Note prev_last = chord.back();
      flush_chord_group(chord, next_bar_time, dur_times, n_durs, zero_index, em,
                        cont);
      if (nte.start >= prev_last.end) {
        double rest = nte.start - prev_last.end;
        if (!duration_is_zero(rest, dur_times, n_durs, zero_index)) {
          em.push(-1);
          emit_duration(em, rest, dur_times, n_durs, zero_index);
        }
      } else {
        em.push(-2);
        emit_duration(em, nte.start - prev_last.start, dur_times, n_durs,
                      zero_index);
      }
      chord.clear();
      chord.push_back(nte);
    }
  }

  if (!chord.empty()) {
    Note last = chord.back();
    flush_chord_group(chord, next_bar_time, dur_times, n_durs, zero_index, em,
                      cont);
    if (last.end < next_bar_time) {
      double rest = next_bar_time - last.end;
      if (!duration_is_zero(rest, dur_times, n_durs, zero_index)) {
        em.push(-1);
        emit_duration(em, rest, dur_times, n_durs, zero_index);
      }
    }
  }
}

}  // namespace

extern "C" {

// Tokenize one bar of one track.  Returns the number of emitted token
// codes, or -1 on output overflow.  `n_continue_out` receives the number
// of tie-notes carried into the next bar.
int smer_tokenize_bar(
    const double* starts, const double* ends, const int32_t* pitches,
    const int32_t* velocities, int n_notes,
    double bar_time, double next_bar_time,
    const double* beat_times, int n_beats,
    double minimum_difference, int grid_division, int do_grid,
    const double* dur_times, int n_durs, int zero_index,
    int32_t* out_tokens, int max_out,
    int32_t* cont_pitches, double* cont_ends, int max_cont,
    int32_t* n_continue_out) {
  Emitter em{out_tokens, max_out};
  ContinueOut cont{cont_pitches, cont_ends, max_cont};

  std::vector<Note> notes;
  notes.reserve(n_notes);
  for (int i = 0; i < n_notes; ++i) {
    notes.push_back({starts[i], ends[i], pitches[i], velocities[i]});
  }
  tokenize_bar_core(notes, bar_time, next_bar_time, beat_times, n_beats,
                    minimum_difference, grid_division, do_grid, dur_times,
                    n_durs, zero_index, em, cont);
  *n_continue_out = cont.n;
  return em.overflow ? -1 : em.n;
}

// Tokenize ALL bars of one track in one call (the corpus tokenizer's hot
// loop; amortizes the Python->C boundary over the whole track).
//
// Inputs:
//   starts/ends/pitches: the track's notes, START-SORTED and pitch-filtered
//   down_beats: n_bars+1 bar boundary times
//   beats/dbi: the beat grid and per-bar downbeat indices (dbi has
//     n_bars+1 entries; bar k's beat window is beats[dbi[k]..dbi[k+1]])
//   table_*: duration tables, one row of `table_stride` times per table,
//     with per-table length/zero-index/minimum-difference; bar_table maps
//     each bar to its table row
// Outputs:
//   out_tokens: concatenated per-bar token codes
//   bar_offsets: n_bars+1 offsets into out_tokens (bar k's tokens are
//     out_tokens[bar_offsets[k]..bar_offsets[k+1]])
// Returns total token count or -1 on overflow (caller falls back).
int smer_tokenize_track(
    const double* starts, const double* ends, const int32_t* pitches,
    int n_notes,
    const double* down_beats, int n_bars,
    const double* beats, const int32_t* dbi,
    int grid_division, int do_grid,
    const double* table_times, const int32_t* table_n,
    const int32_t* table_zero, const double* table_mindiff,
    int table_stride, const int32_t* bar_table,
    int32_t* out_tokens, int max_out, int32_t* bar_offsets) {
  Emitter em{out_tokens, max_out};
  constexpr int kMaxCarry = 512;
  int32_t carry_pitch[kMaxCarry];
  double carry_end[kMaxCarry];
  int carry_n = 0;

  for (int bar = 0; bar < n_bars; ++bar) {
    bar_offsets[bar] = em.n;
    const double bar_time = down_beats[bar];
    const double next_bar_time = down_beats[bar + 1];
    const int t = bar_table[bar];
    const double* times = table_times + static_cast<size_t>(t) * table_stride;
    const int n_durs = table_n[t];
    const int zero_index = table_zero[t];
    const double md = table_mindiff[t];

    std::vector<Note> notes;
    for (int i = 0; i < carry_n; ++i) {
      // ties carried from the previous bar start at this bar line
      notes.push_back({bar_time, carry_end[i], carry_pitch[i], -1});
    }
    // the bar's window is a contiguous start-sorted slice
    const double* lo = std::lower_bound(starts, starts + n_notes, bar_time - md);
    const double* hi =
        std::lower_bound(starts, starts + n_notes, next_bar_time - md);
    for (const double* p = lo; p != hi; ++p) {
      const int i = static_cast<int>(p - starts);
      notes.push_back({starts[i], ends[i], pitches[i], 0});
    }

    ContinueOut cont{carry_pitch, carry_end, kMaxCarry};
    tokenize_bar_core(notes, bar_time, next_bar_time, beats + dbi[bar],
                      dbi[bar + 1] - dbi[bar] + 1, md, grid_division, do_grid,
                      times, n_durs, zero_index, em, cont);
    carry_n = cont.n;
  }
  bar_offsets[n_bars] = em.n;
  return em.overflow ? -1 : em.n;
}

}  // extern "C"
