"""Streaming HAR demo on the PyTorch port: a fleet of live 50 Hz sensors
served by one engine.

    PYTHONPATH=src python examples/torch_streaming_har_demo.py [--streams 12]
        [--slots 4] [--epochs 30] [--device cuda|cpu]

The port's counterpart of ``examples/streaming_har_demo.py``: trains a
small low-rank FastGRNN, deploys it (Q15 PTQ), then replays HAPT test
windows as *interleaved live streams*: sensors come online at staggered
times, push one tri-axial sample per tick, occasionally stall (their
hidden state is held bit-for-bit), finish and detach, and new sensors are
admitted from the pending queue into the freed slots.  On ``cuda`` each
tick is one launch of the Q15 step kernel; every prediction is
bit-identical to the scalar runtime on the same samples.  ``--device``
defaults to ``cuda`` and raises without a card.
"""
import argparse
import collections

import numpy as np

from repro_torch.core import fastgrnn as fg
from repro_torch.core import pipeline as pl
from repro_torch.data import hapt
from repro_torch.serve.streaming import StreamingConfig, StreamingEngine

parser = argparse.ArgumentParser()
parser.add_argument("--streams", type=int, default=12)
parser.add_argument("--slots", type=int, default=4)
parser.add_argument("--epochs", type=int, default=30)
parser.add_argument("--device", default="cuda")
args = parser.parse_args()

# 1. train + deploy (paper config: H=16, r_w=2, r_u=8, Q15 PTQ)
train = hapt.load("train", n=1500)
test = hapt.load("test", n=args.streams)
cfg = fg.FastGRNNConfig(rank_w=2, rank_u=8)
res = pl.train_fastgrnn(cfg, train.windows, train.labels,
                        epochs=args.epochs, seed=0, device=args.device)
rt = pl.deploy(res.params, train.windows[:5], device=args.device)

# 2. streaming engine: fewer slots than sensors -> continuous batching
eng = StreamingEngine(rt.qp, StreamingConfig(max_slots=args.slots,
                                             device=args.device))

# 3. replay test windows as staggered, stalling live streams
rng = np.random.default_rng(0)
cursors = {}                       # stream_id -> next sample index
for i in range(args.streams):
    cursors[f"sensor-{i:02d}"] = 0
start_tick = {f"sensor-{i:02d}": int(rng.integers(0, 40))
              for i in range(args.streams)}
windows = {f"sensor-{i:02d}": test.windows[i] for i in range(args.streams)}
labels = {f"sensor-{i:02d}": int(test.labels[i]) for i in range(args.streams)}

events, tick = [], 0
attached = set()
while len(events) < args.streams:
    for sid, t0 in start_tick.items():
        if tick == t0:
            eng.attach(sid, total_steps=128)
            attached.add(sid)
            print(f"[tick {tick:4d}] {sid} online "
                  f"({eng.n_active} active / {eng.n_pending} pending)")
    for sid in sorted(attached):
        c = cursors[sid]
        if c < 128 and rng.random() > 0.15:      # 15% chance of a stall
            eng.feed(sid, windows[sid][c])
            cursors[sid] = c + 1
    for ev in eng.step():
        events.append(ev)
        cls = hapt.CLASSES[ev.prediction]
        truth = hapt.CLASSES[labels[ev.stream_id]]
        flag = "warm" if ev.warm else "COLD"
        ok = "ok " if ev.prediction == labels[ev.stream_id] else "MISS"
        print(f"[tick {tick:4d}] {ev.stream_id} -> {cls:<10s} "
              f"({flag}, truth {truth:<10s} {ok}, "
              f"{eng.n_active} active / {eng.n_pending} pending)")
    tick += 1

# 4. verify the streaming fleet against the offline scalar runtime
by_id = {e.stream_id: e for e in events}
agree = offline_hits = 0
for sid, w in windows.items():
    offline = rt.predict(w)
    agree += int(by_id[sid].prediction == offline)
    offline_hits += int(offline == labels[sid])
counts = collections.Counter(e.kind for e in events)
print(f"\n{len(events)} predictions ({dict(counts)}), "
      f"{tick} ticks, stats: {eng.stats()}")
print(f"streaming-vs-offline scalar agreement: "
      f"{agree}/{args.streams} (bit-exact contract)")
print(f"accuracy: streaming {sum(int(by_id[s].prediction == labels[s]) for s in windows)}"
      f"/{args.streams}, offline {offline_hits}/{args.streams}")
