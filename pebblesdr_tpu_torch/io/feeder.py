"""Double-buffered input pipeline: a Source read on a thread, overlapped
with the chain's compute.

Port of pebblesdr_tpu/io/feeder.py (host code).  Capability parity with
ProducerConsumer (pebblelib/producerconsumer.h:18-96): the reference runs a
producer QThread filling a semaphore-guarded ring of N buffers while a
consumer thread drains them through the DSP chain.  Here a background
thread reads Source blocks and stages them into a small queue as [N, 2C]
float32 lane-packed planes (re lanes, then im lanes: the Receiver's packed
entry layout); the consumer pulls the next block while the current
dispatch runs on the card (CUDA launches are asynchronous, so the host
copy of block k+1 proceeds while step k executes).

Also carries the reference's overrun accounting (producer overruns when
the consumer stalls, signalspectrum.cpp:73-77): a full queue drops its
oldest block.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from pebblesdr_tpu_torch.io.sources import Source


class Feeder:
    def __init__(self, source: Source, block: int, channels: int = 1,
                 depth: int = 4):
        self.source = source
        self.block = block
        self.channels = channels
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.overruns = 0
        self.blocks_read = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)

    def _producer(self) -> None:
        while not self._stop.is_set():
            blk = self.source.read_block(self.block)
            if blk is None:
                self.q.put(None)
                return
            # [N, 2C] lane-packed plane (re lanes then im lanes)
            ri = np.concatenate([
                np.broadcast_to(blk.real.astype(np.float32)[:, None],
                                (self.block, self.channels)),
                np.broadcast_to(blk.imag.astype(np.float32)[:, None],
                                (self.block, self.channels)),
            ], axis=1)
            self.blocks_read += 1
            try:
                self.q.put(ri, timeout=0.001)
            except queue.Full:
                self.overruns += 1
                try:
                    self.q.get_nowait()  # drop oldest (overrun semantics)
                except queue.Empty:
                    pass
                self.q.put(ri)

    def start(self) -> "Feeder":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            yield item

    def next_block(self, timeout: float = 10.0):
        """Blocking fetch of the next [N, 2C] float32 block (None = end of
        stream)."""
        return self.q.get(timeout=timeout)
