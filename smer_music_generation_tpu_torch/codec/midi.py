"""Self-contained MIDI data model and Standard MIDI File (SMF) I/O.

The reference stack leans on ``pretty_midi`` for every MIDI operation
(reference ``encode.py``, ``preprocessing.py``, ``tension_calculation.py``).
This framework ships its own implementation so it is fully standalone:

* :class:`Note` / :class:`Instrument` / :class:`TimeSignature` /
  :class:`MidiScore` mirror the subset of the ``pretty_midi`` object model
  the pipeline needs (``instruments``, ``time_signature_changes``,
  ``get_beats``, ``get_downbeats``, ``get_tempo_changes``,
  ``get_piano_roll``, ``get_end_time``, ``write``).
* :func:`read_midi` / :meth:`MidiScore.write` implement SMF format 0/1
  parsing and writing directly (no external dependency).

Timing semantics (documented so codec tests can rely on them):

* MIDI tempo is quarter notes per minute; a *beat* is the quarter note for
  ``x/4`` signatures and the dotted quarter for compound signatures
  (numerator divisible by 3 and != 3, e.g. 6/8) — the same convention the
  reference inherits from ``pretty_midi.get_beats`` and bakes into its
  duration tables (reference ``encode.py:213-239``).
* ``get_piano_roll(fs=...)`` truncates note boundaries with ``int(t * fs)``
  exactly like ``pretty_midi`` so occupation/polyphony features match.

Host copy of ``smer_music_generation_tpu/codec/midi.py`` for the PyTorch port,
which imports nothing of the JAX package.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Note",
    "Instrument",
    "TimeSignature",
    "Lyric",
    "MidiScore",
    "read_midi",
    "remove_drum_tracks",
]


def remove_drum_tracks(score: "MidiScore") -> "MidiScore":
    """Drop drum instruments in place (reference ``encode.py:807-814`` /
    ``tension_calculation.py:649-654``)."""
    score.instruments = [i for i in score.instruments if not i.is_drum]
    return score


def piano_roll_to_score(
    piano_roll: np.ndarray, fs: float = 100.0, program: int = 0, tempo: float = 120.0
) -> "MidiScore":
    """(128, T) velocity roll -> single-instrument score (reference
    ``preprocessing.py:145-194``): note boundaries from velocity changes."""
    notes_dim, _ = piano_roll.shape
    score = MidiScore(initial_tempo=tempo)
    inst = Instrument(program=program)
    padded = np.pad(piano_roll, [(0, 0), (1, 1)], "constant")
    change_times, change_notes = np.nonzero(np.diff(padded).T)
    prev_velocity = np.zeros(notes_dim, dtype=int)
    note_on = np.zeros(notes_dim)
    for t_idx, pitch in zip(change_times, change_notes):
        velocity = int(padded[pitch, t_idx + 1])
        t = t_idx / fs
        if velocity > 0:
            if prev_velocity[pitch] == 0:
                note_on[pitch] = t
                prev_velocity[pitch] = velocity
        else:
            inst.notes.append(Note(int(prev_velocity[pitch]), int(pitch), note_on[pitch], t))
            prev_velocity[pitch] = 0
    score.instruments.append(inst)
    return score


@dataclass
class Note:
    velocity: int
    pitch: int
    start: float
    end: float

    @property
    def duration(self) -> float:
        return self.end - self.start

    def __repr__(self) -> str:  # pragma: no cover
        return f"Note(p={self.pitch}, v={self.velocity}, {self.start:.4f}->{self.end:.4f})"


@dataclass
class Instrument:
    program: int = 0
    is_drum: bool = False
    name: str = ""
    notes: List[Note] = field(default_factory=list)

    def get_piano_roll(self, fs: float = 100.0, end_time: Optional[float] = None) -> np.ndarray:
        """Binary-capable (velocity-summed) piano roll sampled at ``fs`` Hz.

        Matches ``pretty_midi``: column span of a note is
        ``[int(start*fs), int(end*fs))``; zero-length spans are dropped.
        """
        if not self.notes:
            return np.zeros((128, 0))
        if end_time is None:
            end_time = max(n.end for n in self.notes)
        n_cols = int(np.ceil(end_time * fs))
        roll = np.zeros((128, max(n_cols, 0)))
        for note in self.notes:
            s = int(note.start * fs)
            e = int(note.end * fs)
            if e > n_cols:
                e = n_cols
            if e > s and 0 <= note.pitch < 128:
                roll[note.pitch, s:e] += note.velocity
        return roll


@dataclass
class TimeSignature:
    numerator: int
    denominator: int
    time: float


@dataclass
class Lyric:
    text: str
    time: float


DEFAULT_RESOLUTION = 220  # ticks per quarter, pretty_midi default


class MidiScore:
    """In-memory MIDI score with ``pretty_midi``-compatible accessors."""

    def __init__(self, initial_tempo: float = 120.0, resolution: int = DEFAULT_RESOLUTION):
        self.resolution = resolution
        self.instruments: List[Instrument] = []
        self.time_signature_changes: List[TimeSignature] = []
        self.lyrics: List[Lyric] = []
        # list of (time, tempo_qpm); piecewise-constant from each time onward
        self._tempo_changes: List[Tuple[float, float]] = [(0.0, float(initial_tempo))]

    # ------------------------------------------------------------------
    # Tempo
    # ------------------------------------------------------------------
    def get_tempo_changes(self) -> Tuple[np.ndarray, np.ndarray]:
        times = np.array([t for t, _ in self._tempo_changes])
        tempi = np.array([q for _, q in self._tempo_changes])
        return times, tempi

    def set_tempo_changes(self, changes: Sequence[Tuple[float, float]]) -> None:
        if not changes:
            changes = [(0.0, 120.0)]
        self._tempo_changes = sorted((float(t), float(q)) for t, q in changes)
        if self._tempo_changes[0][0] != 0.0:
            first = self._tempo_changes[0][1]
            self._tempo_changes.insert(0, (0.0, first))

    @property
    def initial_tempo(self) -> float:
        return self._tempo_changes[0][1]

    # ------------------------------------------------------------------
    def get_end_time(self) -> float:
        ends = [n.end for inst in self.instruments for n in inst.notes]
        ends += [ts.time for ts in self.time_signature_changes]
        ends += [ly.time for ly in self.lyrics]
        return max(ends) if ends else 0.0

    # ------------------------------------------------------------------
    # Beats / downbeats
    # ------------------------------------------------------------------
    def _beat_length(self, numerator: int, denominator: int, tempo: float) -> float:
        quarter = 60.0 / tempo
        beat = quarter * 4.0 / denominator
        if numerator % 3 == 0 and numerator != 3:
            beat *= 3.0  # compound meter: dotted grouping (6/8 -> dotted quarter)
        return beat

    def _segments(self):
        """Yield (start_time, numerator, denominator, tempo) piecewise segments.

        Segment boundaries are the union of time-signature and tempo change
        times.  The produced beat grid restarts at each boundary (matching
        pretty_midi's behavior for changes aligned to bar starts, which is
        the only case the pipeline admits: reference ``encode.py:1172-1192``
        requires a single time signature at t=0).
        """
        sigs = self.time_signature_changes or [TimeSignature(4, 4, 0.0)]
        boundaries = sorted(
            {s.time for s in sigs} | {t for t, _ in self._tempo_changes} | {0.0}
        )
        for b in boundaries:
            num, den = 4, 4
            for s in sigs:
                if s.time <= b + 1e-9:
                    num, den = s.numerator, s.denominator
            tempo = self._tempo_changes[0][1]
            for t, q in self._tempo_changes:
                if t <= b + 1e-9:
                    tempo = q
            yield b, num, den, tempo

    def get_beats(self) -> np.ndarray:
        end = self.get_end_time()
        segs = list(self._segments())
        beats: List[float] = []
        for i, (start, num, den, tempo) in enumerate(segs):
            seg_end = segs[i + 1][0] if i + 1 < len(segs) else end
            bl = self._beat_length(num, den, tempo)
            t = start
            while t < seg_end - 1e-9:
                beats.append(t)
                t += bl
        if not beats:
            beats = [0.0]
        return np.array(beats)

    def get_downbeats(self) -> np.ndarray:
        end = self.get_end_time()
        segs = list(self._segments())
        downs: List[float] = []
        for i, (start, num, den, tempo) in enumerate(segs):
            seg_end = segs[i + 1][0] if i + 1 < len(segs) else end
            bl = self._beat_length(num, den, tempo)
            beats_per_bar = num // 3 if (num % 3 == 0 and num != 3) else num
            bar = bl * beats_per_bar
            t = start
            while t < seg_end - 1e-9:
                downs.append(t)
                t += bar
        if not downs:
            downs = [0.0]
        return np.array(downs)

    # ------------------------------------------------------------------
    def get_piano_roll(
        self,
        fs: float = 100.0,
        times: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Summed piano roll over non-drum-aware instruments.

        With ``times`` given, column ``i`` reports activity in the window
        ``[times[i], times[i+1])`` (the last window extends by the final
        step), using any-overlap semantics — the binarized (> 0) roll then
        marks every grid slot a note sounds in, which is what the tension
        and occupation features consume.
        """
        if times is None:
            end_time = self.get_end_time()
            rolls = [
                inst.get_piano_roll(fs=fs, end_time=end_time) for inst in self.instruments
            ]
            if not rolls:
                return np.zeros((128, 0))
            n = max(r.shape[1] for r in rolls)
            out = np.zeros((128, n))
            for r in rolls:
                out[:, : r.shape[1]] += r
            return out

        times = np.asarray(times, dtype=float)
        n = len(times)
        if n == 0:
            return np.zeros((128, 0))
        if n >= 2:
            last_step = times[-1] - times[-2]
        else:
            last_step = 60.0 / self.initial_tempo
        edges = np.concatenate([times, [times[-1] + last_step]])
        out = np.zeros((128, n))
        eps = 1e-6
        for inst in self.instruments:
            for note in inst.notes:
                if not (0 <= note.pitch < 128):
                    continue
                lo = int(np.searchsorted(edges, note.start + eps, side="right")) - 1
                hi = int(np.searchsorted(edges, note.end - eps, side="right")) - 1
                lo = max(lo, 0)
                hi = min(hi, n - 1)
                if note.end - note.start <= eps:
                    continue
                if hi >= lo:
                    out[note.pitch, lo : hi + 1] += note.velocity
        return out

    # ------------------------------------------------------------------
    # SMF writing
    # ------------------------------------------------------------------
    def _time_to_ticks(self, t: float) -> int:
        # piecewise-constant tempo integration
        ticks = 0.0
        changes = self._tempo_changes
        for i, (ct, tempo) in enumerate(changes):
            seg_end = changes[i + 1][0] if i + 1 < len(changes) else None
            if seg_end is not None and t > seg_end:
                ticks += (seg_end - ct) * tempo / 60.0 * self.resolution
            else:
                ticks += max(t - ct, 0.0) * tempo / 60.0 * self.resolution
                break
        return int(round(ticks))

    def write(self, path: str) -> None:
        tracks: List[bytes] = []

        # track 0: meta (tempo + time signatures)
        meta_events: List[Tuple[int, bytes]] = []
        for t, tempo in self._tempo_changes:
            mpq = int(round(60_000_000 / tempo))
            meta_events.append(
                (self._time_to_ticks(t), bytes([0xFF, 0x51, 0x03]) + mpq.to_bytes(3, "big"))
            )
        for ts in self.time_signature_changes:
            dd = max(int(round(np.log2(ts.denominator))), 0)
            meta_events.append(
                (
                    self._time_to_ticks(ts.time),
                    bytes([0xFF, 0x58, 0x04, ts.numerator, dd, 24, 8]),
                )
            )
        for ly in self.lyrics:
            data = ly.text.encode("latin-1", "replace")
            meta_events.append(
                (self._time_to_ticks(ly.time), bytes([0xFF, 0x05, len(data)]) + data)
            )
        tracks.append(_encode_track(meta_events))

        channel_cursor = 0
        for inst in self.instruments:
            if inst.is_drum:
                channel = 9
            else:
                channel = channel_cursor
                channel_cursor += 1
                if channel_cursor == 9:
                    channel_cursor += 1
                channel_cursor %= 16
                if channel_cursor == 9:
                    channel_cursor += 1
            events: List[Tuple[int, bytes]] = [
                (0, bytes([0xC0 | channel, inst.program & 0x7F]))
            ]
            for note in inst.notes:
                on = self._time_to_ticks(note.start)
                off = self._time_to_ticks(note.end)
                v = min(max(int(note.velocity), 1), 127)
                p = min(max(int(note.pitch), 0), 127)
                events.append((on, bytes([0x90 | channel, p, v])))
                events.append((off, bytes([0x80 | channel, p, 0])))
            tracks.append(_encode_track(events))

        with open(path, "wb") as f:
            f.write(b"MThd" + struct.pack(">IHHH", 6, 1, len(tracks), self.resolution))
            for tr in tracks:
                f.write(tr)


def _write_varlen(value: int) -> bytes:
    out = bytearray([value & 0x7F])
    value >>= 7
    while value:
        out.insert(0, 0x80 | (value & 0x7F))
        value >>= 7
    return bytes(out)


def _encode_track(events: List[Tuple[int, bytes]]) -> bytes:
    # stable sort by tick; note-offs at the same tick precede note-ons so a
    # repeated pitch re-triggers cleanly
    def order(ev):
        tick, data = ev
        status = data[0] & 0xF0
        pri = 0 if status in (0x80,) else (2 if status == 0x90 and len(data) > 2 and data[2] > 0 else 1)
        return (tick, pri)

    events = sorted(events, key=order)
    body = bytearray()
    last = 0
    for tick, data in events:
        body += _write_varlen(max(tick - last, 0))
        body += data
        last = max(tick, last)
    body += _write_varlen(0) + bytes([0xFF, 0x2F, 0x00])
    return b"MTrk" + struct.pack(">I", len(body)) + bytes(body)


# ---------------------------------------------------------------------------
# SMF parsing
# ---------------------------------------------------------------------------


def _read_varlen(data: bytes, pos: int) -> Tuple[int, int]:
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, pos


def _parse_track_events(tdata, stream, tempo_events, sig_events, lyric_events):
    """Decode one MTrk chunk's event stream (ticks stay raw).

    Lenient where real-world exporters are sloppy: running status is
    honoured across meta/sysex events (the spec says those cancel it, but
    many exporters rely on it surviving), unknown meta types and sysex
    payloads are skipped, and channel messages before any status byte are
    consumed as no-ops.  IndexError (data bytes running past the chunk)
    propagates to the caller, which rejects the file.
    """
    tick = 0
    p = 0
    running = 0
    while p < len(tdata):
        delta, p = _read_varlen(tdata, p)
        tick += delta
        status = tdata[p]
        if status & 0x80:
            p += 1
            if status < 0xF0:
                running = status
        else:
            status = running
        kind = status & 0xF0
        ch = status & 0x0F
        if status == 0xFF:
            meta = tdata[p]
            p += 1
            length, p = _read_varlen(tdata, p)
            payload = tdata[p : p + length]
            p += length
            if meta == 0x51 and length == 3:
                mpq = int.from_bytes(payload, "big")
                if mpq > 0:
                    tempo_events.append((tick, 60_000_000 / mpq))
            elif meta == 0x58 and length >= 2:
                sig_events.append((tick, payload[0], 2 ** payload[1]))
            elif meta == 0x05:
                lyric_events.append((tick, payload.decode("latin-1", "replace")))
        elif status in (0xF0, 0xF7):
            length, p = _read_varlen(tdata, p)
            p += length
        elif kind in (0x80, 0x90, 0xA0, 0xB0, 0xE0):
            d1, d2 = tdata[p], tdata[p + 1]
            p += 2
            if kind == 0x90 and d2 > 0:
                stream.append((tick, ch, "on", d1, d2))
            elif kind == 0x80 or (kind == 0x90 and d2 == 0):
                stream.append((tick, ch, "off", d1, d2))
        elif kind in (0xC0, 0xD0):
            d1 = tdata[p]
            p += 1
            if kind == 0xC0:
                stream.append((tick, ch, "program", d1, 0))
        elif status == 0:
            # data byte with no running status established: consume it as
            # a no-op rather than re-reading it as a delta forever
            p += 1


def read_midi(path: str) -> MidiScore:
    """Parse an SMF file (format 0/1) into a :class:`MidiScore`."""
    with open(path, "rb") as f:
        data = f.read()

    if data[:4] != b"MThd":
        raise ValueError(f"{path}: not a MIDI file")
    if len(data) < 14:
        raise ValueError(f"{path}: truncated MThd header")
    hlen, fmt, ntracks, division = struct.unpack(">IHHH", data[4:14])
    if division & 0x8000:
        raise ValueError("SMPTE time division not supported")
    if division == 0:
        raise ValueError(f"{path}: zero ticks-per-quarter division")
    resolution = division

    pos = 8 + hlen
    raw_tracks = []
    for _ in range(ntracks):
        if data[pos : pos + 4] != b"MTrk":
            raise ValueError("bad track chunk")
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated MTrk header")
        (tlen,) = struct.unpack(">I", data[pos + 4 : pos + 8])
        if pos + 8 + tlen > len(data):
            raise ValueError(f"{path}: truncated MTrk data "
                             f"(declared {tlen} bytes)")
        raw_tracks.append(data[pos + 8 : pos + 8 + tlen])
        pos += 8 + tlen

    # pass 1: gather events in ticks
    tempo_events: List[Tuple[int, float]] = []  # (tick, qpm)
    sig_events: List[Tuple[int, int, int]] = []  # (tick, num, den)
    lyric_events: List[Tuple[int, str]] = []
    # (tick, channel, kind, pitch, velocity, program) per track
    note_streams = []

    for tdata in raw_tracks:
        stream: List[Tuple[int, int, str, int, int]] = []
        try:
            _parse_track_events(tdata, stream, tempo_events, sig_events,
                                lyric_events)
        except IndexError as e:
            # an event whose data bytes run past the declared chunk length
            # (mid-write truncation, bad running status): reject cleanly so
            # the build pipeline's per-file containment sees one error type
            raise ValueError("truncated event data inside MTrk") from e
        note_streams.append(stream)

    # tempo metas can live in any track of a format-1 file: sort before
    # the piecewise accumulation below, which assumes ascending ticks
    tempo_events.sort(key=lambda e: e[0])
    if not tempo_events or tempo_events[0][0] != 0:
        tempo_events.insert(0, (0, 120.0))

    # ticks -> seconds under piecewise tempo
    def tick_to_time(tick: int) -> float:
        t = 0.0
        for i, (ct, qpm) in enumerate(tempo_events):
            nxt = tempo_events[i + 1][0] if i + 1 < len(tempo_events) else None
            if nxt is not None and tick > nxt:
                t += (nxt - ct) * 60.0 / qpm / resolution
            else:
                t += max(tick - ct, 0) * 60.0 / qpm / resolution
                break
        return t

    score = MidiScore(initial_tempo=tempo_events[0][1], resolution=resolution)
    score.set_tempo_changes([(tick_to_time(tk), q) for tk, q in tempo_events])
    score.time_signature_changes = [
        TimeSignature(num, den, tick_to_time(tk)) for tk, num, den in sorted(sig_events)
    ]
    score.lyrics = [Lyric(text, tick_to_time(tk)) for tk, text in sorted(lyric_events)]

    # pass 2: pair note on/off per (track, channel, pitch)
    for stream in note_streams:
        per_channel: dict = {}
        insts: dict = {}

        def get_inst(ch: int) -> Instrument:
            if ch not in insts:
                insts[ch] = Instrument(program=per_channel.get(ch, 0), is_drum=(ch == 9))
            return insts[ch]

        active: dict = {}
        for tick, ch, kind, d1, d2 in sorted(stream, key=lambda e: (e[0], e[2] != "off")):
            if kind == "program":
                per_channel[ch] = d1
                if ch in insts and not insts[ch].notes:
                    insts[ch].program = d1
            elif kind == "on":
                active.setdefault((ch, d1), []).append((tick, d2))
            elif kind == "off":
                lst = active.get((ch, d1))
                if lst:
                    on_tick, vel = lst.pop(0)
                    if tick > on_tick:
                        get_inst(ch).notes.append(
                            Note(vel, d1, tick_to_time(on_tick), tick_to_time(tick))
                        )
        for ch in sorted(insts):
            if insts[ch].notes:
                insts[ch].notes.sort(key=lambda n: (n.start, n.end, n.pitch))
                score.instruments.append(insts[ch])

    return score
