#!/usr/bin/env python3
"""Drive the PyTorch port (deeplearning4j_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version at the shapes the serving and
training paths give it (the LSTM sequence forward and backward and the
cell forward also against two wrong products the limits must catch; the
backward's dRW product also alone, at R = T*B from 64 to 16384 rows, and
against two wrong dRW products in the sequence and cell backwards), then
drives the paths through the port's entry
points at full width (char-RNN: vocab 96, hidden 512, 2 layers, B=64,
T=256): serving (output/predict, decode with 8 slots); training with SGD
(fit, standard backprop and TBPTT(50), f32 and bf16 compute, on the card and
on the CPU from the same seed params and data); and the char-RNN's own
training recipe (``char_rnn()`` defaults: Adam at lr 1e-3, TBPTT(50), on
variable-length text padded by ``BucketingSequenceIterator`` to T=128 or
256, so through the masked LSTM kernels), then ``evaluate`` and a
write/restore/continue of a checkpoint. Then a causal self-attention net
(two blocks of SelfAttention and LayerNorm, n_out 512, 8 heads, over the
same vocab; B=4, T=4096): the flash-attention kernels against their plain
versions and three wrong ones, ``output``/``predict`` with and without
padding, bucketed Adam training (T up to 4096) against the CPU at T<=512,
``evaluate`` and an exact resume. Then AlexNet (``alexnet_conf()`` at its
own widths, 224x224x3 images, 1000 classes, B=128, random weights from the
seed): the LRN kernels against their plain versions (C from 1 to 16384,
views one element past 16 bytes) and two wrong ones,
softmax-xent at N=128, C=1000, ``output``/``predict`` (card against CPU on
8 images), Nesterov training at lr 1e-2 (card against CPU on 8 images with
dropout 0, a faulty LRN backward the limits must catch, ``evaluate``, an
exact resume; then the conf's dropout 0.5 at B=128, timed). Then GoogLeNet
(``googlenet_conf()``, a ComputationGraph of 9 inception merges, at its own
widths, B=128): the LRN kernels also at its [128, 56, 56, 64] and [128, 56,
56, 192], ``output``/``predict`` (card against CPU on 4 images, 2 LRN
launches a call), Nesterov training with the two auxiliary heads (card
against CPU on 4 images with dropout 0, 2 + 2 LRN launches and one
softmax-xent forward and backward per head per update, a MergeVertex with
two branches swapped and a faulty LRN backward the limits must catch,
``evaluate`` per head, an exact resume; then the conf's dropout 0.4 at
B=128, timed with the batch from the host and on the card). Then ResNet-50
(``resnet50_conf()``, a ComputationGraph of 174 vertices with 53
BatchNormalization layers, at bench.py's B=128, 224x224x3, 1000 classes):
``output``/``predict`` on a running state that is not the initial one (card
against CPU on 2 images, no hand-kernel launch), SGD at the conf's lr 0.1
(card against CPU on 4 images, f32 and bf16, with BN's variance unbiased,
its decay the wrong way round, eval on batch stats and a dropped shortcut
that the limits must catch; one softmax-xent forward and backward per
update; ``evaluate``; an exact resume through a zip with the layer state),
timed updates from the host and on the card, peak memory and a profiled
update. Then LeNet (``lenet_mnist_conf()``, B=64) and the MNIST MLP of
examples/mlp_mnist.py (B=512), Adam on MultiLayerNetwork over the synthetic
MNIST, card against CPU with two wrong Adams caught, one softmax-xent
forward and backward and one Adam launch per update, timed. Then the
char-RNN again on the per-step cell route (``lstm_variant="fusedcell"``):
the cell kernels against their plain versions (every activation pair, B
1-67, H 129, 130 and 512) and four wrong ones, ``output``/``predict`` and decode
against the CPU and the seqfused route, SGD (standard and TBPTT) and the
recipe against the CPU's cell route and, in f32, the card's seqfused route.
Then the JAX package's accuracy pins on real data (tests/test_accuracy_parity.py)
through the datasets tier: LeNet on the bundled handwritten digits (18 epochs of
DigitsDataSetIterator, held-out accuracy >= 0.95) and an MLP on Iris (200
epochs, >= 0.95) from JAX's initial params (tests/data/jax_init_real_data.npz),
their first updates against the CPU port's with two wrong Adams caught; the
pangram char-RNN (H=96, TBPTT 32, 60 epochs, <= 1.8 bits/char) from the port's
own init; and the char-RNN at full width fed from CSV sequence files through
SequenceRecordReaderDataSetIterator (its masks reach rows 8-9), its first batch
against the CPU, with evaluate() over Iris records naming each misclassified
record's file and line. Rows 5-12 are held against their plain versions and
timed at those shapes too. Then slice 18: the char-RNN as a
ComputationGraph (in -> lstm0 -> lstm1 -> out) trained with TBPTT(50) and
char_rnn()'s Adam against the MultiLayerNetwork from the same weights, f32
and bf16 (each segment's loss, every param; a graph whose segments restart
from zero h/c caught), its ``output``, ``rnn_time_step`` one step at a time
and DecodeServer over the graph against the MLN server and each session
alone (a slot reset that skips the graph's state caught); a sequence
classifier (ids, RnnEmbeddingLayer, GravesLSTM, Convolution1DLayer,
LastTimeStepVertex, softmax) over the recipe's bucketed text against the
CPU (a LastTimeStep that ignores the mask caught); and the attention net
with examples/long_context.py's MixtureOfExpertsLayer after each
LayerNorm (n_out 512, 4 experts of 1024) against the CPU at T <= 512 (pad
tokens claiming capacity caught), timed at T 2048 and 4096 with the peak
memory.
Then slice 20: ResNet-50 (B=128, f32) trained with LAMB under a Telemetry
session (fetch_every 4) and the Score, Performance and CollectScores
listeners, per batch and through fit(stage_on_device=4) (each fetched row's
loss the loss fit reported, bit for bit; one host read per 4 per-batch
updates and per staged window; the grad norm against a float64 recompute
from the gradients a listener sees, with and without loss_scale 1024; the
norm of the scaled gradients and LAMB without its trust ratio caught;
memory_report's totals against the live tensors, nothing allocated; ms per
update with telemetry off and on, eager and replayed, beside SGD's); the
seven optax updaters (adamw, adamax, adadelta, adagrad, rmsprop, lamb, lion)
on the full-width char-RNN against the CPU (adadelta at the conf's rate
caught) and staged against per-batch fit, bit for bit; LBFGS, conjugate
gradient and line gradient descent on the Iris MLP against the CPU; and the
watchdog and flight recorder on the MNIST MLP with a NaN batch, per batch
and staged.
Those phases run under DL4JTPU_INFER=legacy (output(), predict() and
rnn_time_step() eager at the request's shape, as before slice 21). Then
slice 21 on the default path, each bucket a CUDA graph replayed: GoogLeNet
(B=128 and requests of 1-100 rows), ResNet-50 (B=128, no row padding) and
the full-width char-RNN (T=256 and 200, single steps at B=8), f32 and bf16,
against the eager path (bit for bit at exact bucket shapes, within limits
when padded, the streaming state after a bucketed T=200, no capture after
warm-up; a hot swap that rebinds the params, bf16 casts rebound by an
update, padding without the mask and replays without the network's lock
caught); then every other model the phases above serve (the attention net,
the MoE block, AlexNet, the fusedcell and graph char-RNNs with a decode
through each, the sequence classifier) the same way, f32; then GoogLeNet
and the char-RNN on one InferenceService under client threads for timed
windows, each result against its eager output alone, and decode rounds
through the service in turn with an eager DecodeServer (a slot reset that
rebinds the state caught). Slice 21's launch counts are those of the
served calls alone, the eager yardstick's apart.
Slice 23's phase (``ui_lenet``) runs first, right after the build, on
the default path (the profiler's trace of a window drops kernels in a
process that has run for minutes): MNIST-sized IDX files
written from the seed and read by the C++ loader's reader and in Python
(bit for bit), LeNet trained at B=64 through ``NativeDataSetIterator``
under ``StatsListener`` (SQLite), ``ConvolutionalIterationListener`` and
``ProfilingListener`` (rows 10-12 once an update in the traced window, by
``scripts/torch_analyze_trace.py``), its first losses against the CPU's;
the dashboard's pages and endpoints over the listener's file; the net
served over ``POST /serving/predict``; t-SNE and k-means of its
penultimate features on the card against the CPU; a loader that repeats a
batch or does not reshuffle, mean magnitudes without the abs, a flipped
t-SNE gains rule and an answer from another model caught.
Then slice 24, the NLP stack and graph embeddings on the default path, every
corpus and graph drawn from the seed: Word2Vec at 300 dimensions (skip-gram,
HS and 5 negatives, window 5, min count 5) on 500,000 tokens of Zipf words
with planted topics and polarities (a head fit on the card against the CPU
and against itself; a syn1 update from the updated syn0, a NEG step without
its target skip and a flipped HS code sign caught; planted-topic recall; the
C text, C binary and zip formats read back; the HS and NEG steps timed; a
profiled fit's idle share), ParagraphVectors (DBOW, DM) with infer_vector
on the card against the CPU and held-out predict, GloVe at the JAX defaults,
DistributedWord2Vec with 4 workers, DeepWalk at BlogCatalog's size (a
stochastic block model of 10,312 vertices, 39 groups and 334,000 edges read
through the edge-list loader), and DL4J's Word2VecSentimentRNN: the 300-d
vectors through Word2VecDataSetIterator into a GravesLSTM(256) classifier
trained with Adam (rows 8-12, exact launches; its first 2 updates against
the CPU; an iterator with the labels at the padded last step caught;
held-out accuracy), with rows 8-12 held and timed at its shapes.
Then slice 25, Keras model import and the Keras gateway on the default path,
every archive written from the seed by ``scripts/torch_write_keras_h5.py``
(numpy, no h5py) and read back by the port's own HDF5 reader: rows 5-9 and
dRW with Keras's hardsigmoid gate at T=40, B=128, H=128 (f32 and bf16,
against their plain versions, the wrong products caught); the LSTM text
generator of Keras's examples/lstm_text_generation.py (Keras 1.2: LSTM(128)
over 40 one-hot characters of 57, Dense, softmax) imported by guess_model
and served at B=128 against a float64 numpy Keras LSTM and the CPU (gate
blocks in Keras's order and sigmoid gates caught), the example's 100-char
generation loop at B=1, 4 RMSprop updates from the archive's training
config against the CPU; VGG16 of the zoo (138.4M params) from a 553 MB
weights-only 'th' archive through TrainedModels.load, served at B=64 eager
and replayed, held on 2 images against a CPU F.conv2d oracle over the raw
OIHW kernels and the CPU (a skipped flatten permutation caught), its first
Nesterov update at B=2 against the CPU and 3 updates at B=32 timed; a
GatewayServer session (model (a)'s JSON with Adam: create, 4 fits,
predict, evaluate) against the same session on the CPU; rows 5-7, dRW and
10-12 held and timed at those shapes.
It checks the results and the kernel launch counts of each path, and times
the kernels and the training update.
Every phase prints one JSON line and raises on failure; the last line is
{"ok": true, "device": {...}}. It exits non-zero, printing no result, where
CUDA or the port's package is missing. It imports no JAX and nothing of the
JAX package.
"""

from __future__ import annotations

import importlib
import itertools
import json
import os
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
STARTED = time.perf_counter()

# full width of the served char-RNN (bench.py's char-RNN configuration)
VOCAB, HIDDEN, LAYERS, BATCH, STEPS = 96, 512, 2, 64, 256
SLOTS, DECODE_CHARS = 8, 32
SEED = 1234
DEVICE = "cuda"
# training: SGD at this rate, TBPTT segments of 50 steps (five and a 6-step
# tail per batch); batches compared with the CPU by mode (3 of each before
# the training recipe's phase came, which needed the time), 2 more timed
TBPTT, LR, TIMED_BATCHES = 50, 0.1, 2
TRAIN_BATCHES = {"standard": 2, "tbptt": 1}
# repetitions of a plain version when it is timed: it runs 10-30x slower than
# its kernel, and its time is only reported
PLAIN_REPS = {"reps": 3, "warmup": 1}
UPDATES_PER_BATCH = {"standard": 1, "tbptt": -(-STEPS // TBPTT)}
# softmax-xent rows: a standard batch (B*T) and a TBPTT segment (B*50)
SXENT_ROWS = (BATCH * STEPS, BATCH * TBPTT)
# rows 10-11 held against their plain versions at [N, C]: the char-RNN's
# two row counts (rows in registers, 16-byte loads); C=97, whose rows start
# unaligned (rows in registers, element loads); C=1500, wider than the
# register kernels (the forward's loop kernel). AlexNet's C=1000 is held in
# phase_kernels_lrn.
SXENT_CASES = tuple((N, VOCAB) for N in SXENT_ROWS) + ((1001, 97), (128, 1500))

# stated tolerances, max abs error against the plain version on the same
# CUDA tensors: f32 differs only in the order of the recurrent product's sum;
# bf16 rounds every elementwise result as the plain version does, but a sum
# in another order can round one step's value to the neighbouring bf16,
# which the recurrence carries on
KERNEL_ATOL = {"float32": 1e-4, "bfloat16": 3e-2}
# the training kernels in f32, at the f32 limit: the elementwise outputs as
# max abs error; dRW and the peephole grads, which sum T*B = 16384 terms
# each, as max abs error over their largest element. The softmax-xent
# kernels compute in f32 for either input type, so their f32 outputs are
# held at the f32 limit and their bf16 outputs (dx, dl of bf16 inputs) at
# one bf16 step of values below 1.
SUMMED_GRADS = ("dRW", "dpF", "dpI", "dpO")
BWD_NAMES = ("dzx", "dh0", "dc0") + SUMMED_GRADS
# the LSTM training kernels in bf16, each output (and each gate column
# a, f, o, i of dzx) relative to its own size: max |err| / max |ref| and
# mean |err| / mean |ref|. An absolute limit would be as large as a typical
# gradient (dzx ~1e-2). Limits by sequence length: over the 6-step TBPTT
# tail the recurrence has not yet carried a neighbouring-bf16 rounding far;
# at 50 and 256 steps it has. Each limit sits between the error a correct
# kernel shows and what a wrong one gives. Correct, on the H100 (rows 6 and
# 7, worst output): tail max 0.0053 and mean 5.1e-5; 50 and 256 steps max
# 0.0146 and mean 0.0044. Wrong, on the plain version at H=512, worst
# output: a dropped term (d_o*pO in dc, d_f*pF in the carry) reads max
# 5.5-8% and mean 2.2-3.8%; a bf16 rounding point dropped, or dh kept in
# f32, mean 0.30-0.72%, which only the tail can tell from a right kernel
# (scripts/torch_bf16_grad_sensitivity.py, T=6 and 50).
BF16_TRAIN_REL = {"tail": {"max": 2e-2, "mean": 5e-4},
                  "long": {"max": 3e-2, "mean": 1e-2}}
TAIL = STEPS % TBPTT
# training on the card against the same training on the CPU: the loss of
# every update relative to the CPU's, the params after the last update (f32
# master params in both dtypes), and the params' change from the seed params
# relative to its own norm, per tensor, so an update left out reads 1. In
# bf16 compute the gradients carry the bf16 rounding of the activations, so
# the limits are looser there. Each is about 17x (10x for the bf16 change)
# the worst reading on the H100: f32 loss 1.2e-7, params 1.2e-7, change
# 1.1e-5; bf16 5.5e-5, 5.8e-5 and 2.9e-3.
TRAIN_LOSS_RTOL = {"float32": 2e-6, "bfloat16": 1e-3}
TRAIN_PARAM_ATOL = {"float32": 2e-6, "bfloat16": 1e-3}
TRAIN_STEP_RTOL = {"float32": 2e-4, "bfloat16": 3e-2}
# the text trained on: a sentence of this many characters drawn from the
# seed, repeated, so the loss falls visibly over the compared updates
SENTENCE = 61
# served probabilities, card against the same net on the CPU
SERVE_ATOL = {"float32": 1e-4, "bfloat16": 2e-2}
DECODE_ATOL = 1e-5  # a decode session's outputs, batched against alone (f32)

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, and
# dense operations/s for f32 outside the tensor cores and for bf16
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
# f32-accurate products on the tensor cores: 3xTF32 takes three TF32
# products (495 TFLOP/s dense) for each, 165 TFLOP/s. Every f32 product of
# the hand kernels runs there, and is bounded at it: the flash kernels (rows
# 13-15), the LSTM's forward step (rows 1, 5, 6 and 8), the sequence
# backward (rows 7 and 9) and the cell backward (row 2, whose dh_prev
# product runs there and whose dRW product could).
F32_TC_OPS_PER_S = 495e12 / 3

# each kernel: its source and the pallas_call it replaces
CSRC = "deeplearning4j_tpu_torch/ops/csrc/"
PALLAS = "deeplearning4j_tpu/ops/pallas_kernels.py:"
KERNELS = {
    "lstm_seq_lean": (CSRC + "lstm_seq.cu", PALLAS + "509"),
    "lstm_seq_lean_masked": (CSRC + "lstm_seq.cu", PALLAS + "509"),
    "lstm_seq_train_fwd": (CSRC + "lstm_seq.cu", PALLAS + "546"),
    "lstm_seq_bwd": (CSRC + "lstm_seq_bwd.cu", PALLAS + "603"),
    "softmax_xent_fwd": (CSRC + "softmax_xent.cu", PALLAS + "946"),
    "softmax_xent_bwd": (CSRC + "softmax_xent.cu", PALLAS + "968"),
    "lstm_seq_masked_train_fwd": (CSRC + "lstm_seq.cu", PALLAS + "772"),
    "lstm_seq_masked_bwd": (CSRC + "lstm_seq_bwd.cu", PALLAS + "828"),
    "adam_update": (CSRC + "adam.cu", PALLAS + "1044"),
    # row 12's device-scalar entry (dl4j_adam_update_multi_dev), the update
    # of a captured training step
    "adam_update_dev": (CSRC + "adam.cu", PALLAS + "1044"),
}
# the backward's dRW product (rows 2, 7 and 9 launch it inside their C
# entries; ops.lstm_sequence.drw_product alone): the sum of h_prev^T dzx of
# _seq_bwd_kernel (pallas_kernels.py:427-429, in the pallas_call at :603),
# of its masked twin (:828) and of the cell's _bwd_kernel (:137-139, :202)
DRW_KERNELS = {"drw_product": (CSRC + "lstm_drw.cuh", PALLAS + "603")}
# the char-RNN's own training recipe (char_rnn() defaults: Adam, lr 1e-3,
# TBPTT(50)): next-char sequences of the seeded sentence, lengths drawn from
# the seed, RECIPE_SHORT of them in 96..128 and RECIPE_LONG in 129..256,
# bucketed by BucketingSequenceIterator into batches of 64 padded to 128 or
# 256: one batch of each, 3 + 6 = 9 updates an epoch
RECIPE_BUCKETS, RECIPE_SHORT, RECIPE_LONG = (128, 256), 64, 64
RECIPE_LR = 1e-3  # char_rnn()'s default, checked against the built conf
# the Adam kernel against its plain version: each output's max |err| over its
# max |ref|. Both round each operation once in f32; torch divides by a
# scalar as a multiplication by its reciprocal, one rounding more.
ADAM_REL = 1e-6


def emit(phase: str, **fields) -> None:
    """One JSON line for ``phase``, with the seconds since the script began."""
    print(json.dumps({"phase": phase, "t_s": time.perf_counter() - STARTED, **fields}),
          flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def median_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median of ``reps`` timed calls of ``fn`` (CUDA events, after warm-up)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def roofline(nbytes: float, ops: float, dtype: str, ops_per_s: float = None):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over HBM
    and the operations at the dtype's peak (or at ``ops_per_s``)."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / (ops_per_s or PEAK_OPS_PER_S[dtype]) * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def tc_rate(dtype: str):
    """The peak of a product on the tensor cores: 3xTF32 for f32, bf16's
    own (None: PEAK_OPS_PER_S)."""
    return F32_TC_OPS_PER_S if dtype == "float32" else None


def bound(T: int, B: int, H: int, dtype: str, masked: bool, live: float = 1.0):
    """Least time for one layer-forward of the sequence op: each input read
    once and each output written once over HBM, or the recurrent product's
    2*B*H*4H*T operations at the tensor cores' peak (f32 at the 3xTF32
    rate), whichever is larger. Of a masked call only the ``live`` share of
    the T*B (step, row) pairs whose mask is 1 needs its zx read and its
    product (a masked pair carries h and c over); ys is written whole. The
    dependency from one step to the next is not in it."""
    item = 4 if dtype == "float32" else 2
    elems = (T * B * 4 * H * live + (T * B if masked else 0) + 4 * B * H
             + H * 4 * H + 3 * H + T * B * H)
    return roofline(elems * item, 2.0 * B * H * 4 * H * T * live, dtype, tc_rate(dtype))


def live_share(mask) -> float:
    """The share of a sequence mask's (step, row) pairs that are 1."""
    return float(mask.float().mean())


def bound_train_fwd(T: int, B: int, H: int, dtype: str, masked: bool = False):
    """Rows 6 and 8: zx, h0, c0, RW and the peepholes (and the [T, B] mask)
    read; ys and the residuals a, f, o, i, c ([T, B, H] each), hT and cT
    written; the recurrent product's 2*B*H*4H*T operations (masked too: the
    gates of a masked step are residuals the function returns)."""
    item = 4 if dtype == "float32" else 2
    elems = (T * B * 4 * H + 2 * B * H + H * 4 * H + 3 * H + 6 * T * B * H + 2 * B * H
             + (T * B if masked else 0))
    return roofline(elems * item, 2.0 * B * H * 4 * H * T, dtype, tc_rate(dtype))


def bound_bwd(T: int, B: int, H: int, dtype: str, live: float = 1.0,
              masked: bool = False):
    """Rows 7 and 9: dys, ys (as h_{t-1}), a, f, o, i, c (as c_{t-1})
    [T, B, H], dhT, dcT, h0, c0, RW and the peepholes (and the [T, B] mask)
    read; dzx [T, B, 4H], dh0, dc0, dRW and the three peephole grads
    written. Operations: the recurrent product dzx @ RW^T (2*4H*H per row
    and step) and dRW (2*H*4H per row and step), for the ``live`` share of
    the T*B (step, row) pairs whose mask is 1: a masked pair's dzx is 0 and
    needs neither (the dh carried through it is scratch, not an output).
    f32 at the 3xTF32 rate, bf16 at its tensor-core peak."""
    item = 4 if dtype == "float32" else 2
    elems = (7 * T * B * H + 4 * B * H + H * 4 * H + 3 * H
             + T * B * 4 * H + 2 * B * H + H * 4 * H + 3 * H + (T * B if masked else 0))
    return roofline(elems * item, 2 * (2.0 * B * 4 * H * H * T) * live, dtype,
                    tc_rate(dtype))


def bound_adam(n: int):
    """Row 12 over ``n`` f32 elements: g, m, v read and u, m', v' written
    (24 bytes an element), about 12 operations an element."""
    return roofline(24.0 * n, 12.0 * n, "float32")


def adam_launches(net) -> int:
    """Row-12 launches of one Adam update of ``net``: one per MAX_LEAVES
    param leaves (ceil(leaves / MAX_LEAVES))."""
    from deeplearning4j_tpu_torch.ops.adam import MAX_LEAVES

    return -(-sum(len(p) for p in net._leaves()) // MAX_LEAVES)


def bound_sxent(N: int, C: int, dtype: str, backward: bool):
    """Rows 10-11 (logits and labels of one dtype, math in f32): forward
    reads x and labels and writes the f32 row losses, 7 operations an
    element; backward reads x, labels and g and writes dx and dl, 14 an
    element."""
    item = 4 if dtype == "float32" else 2
    if backward:
        return roofline(4 * N * C * item + 4 * N, 14.0 * N * C, "float32")
    return roofline(2 * N * C * item + 4 * N, 7.0 * N * C, "float32")


def seq_inputs(torch, T, B, H, dtype, masked, seed):
    """Sequence-op inputs on the card from a numpy seed, scaled as the
    served char-RNN's are (xavier RW, forget bias 1); ragged mask."""
    import numpy as np

    rng = np.random.default_rng(seed)
    zx = rng.normal(0.0, 0.5, (T, B, 4 * H))
    zx[..., H:2 * H] += 1.0
    arrs = [zx, rng.normal(0.0, 0.5, (B, H)), rng.normal(0.0, 0.5, (B, H)),
            rng.normal(0.0, (1.0 / H) ** 0.5, (H, 4 * H)),
            rng.normal(0.0, 0.1, H), rng.normal(0.0, 0.1, H), rng.normal(0.0, 0.1, H)]
    if masked:  # ragged lengths; a decode tick steps a random subset of slots
        if T == 1:
            mask = (rng.random((1, B)) < 0.5).astype(np.float64)[..., None]
        else:
            lengths = rng.integers(1, T + 1, B)
            mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float64)[..., None]
        arrs.insert(1, mask)
    dt = getattr(torch, dtype)
    return [torch.as_tensor(a, dtype=dt, device=DEVICE).contiguous() for a in arrs]


def char_rnn_params(conf, seed):
    """Random char-RNN weights from a numpy seed, as one dict of arrays per
    layer in the JAX package's layout (what load_jax_params takes)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    params = []
    for layer in conf.layers:
        n_in, n_out = layer.n_in, layer.n_out
        if type(layer).__name__ == "GravesLSTM":
            H = n_out
            b = np.zeros(4 * H)
            b[H:2 * H] = layer.forget_gate_bias_init
            params.append({
                "W": rng.normal(0.0, (2.0 / (n_in + H)) ** 0.5, (n_in, 4 * H)),
                "RW": rng.normal(0.0, (1.0 / H) ** 0.5, (H, 4 * H)),
                "b": b,
                "pF": rng.normal(0.0, 0.1, H),
                "pI": rng.normal(0.0, 0.1, H),
                "pO": rng.normal(0.0, 0.1, H),
            })
        else:
            params.append({"W": rng.normal(0.0, (2.0 / (n_in + n_out)) ** 0.5,
                                           (n_in, n_out)),
                           "b": np.zeros(n_out)})
    return params


SEQ_CASES = ((STEPS, BATCH, False), (STEPS, BATCH, True), (1, SLOTS, True), (1, SLOTS, False))


def phase_kernels(torch, ls, gate="sigmoid", H=HIDDEN, cases=SEQ_CASES,
                  dtypes=("float32", "bfloat16")):
    """Each kernel mode (row 5, unmasked and masked) against its plain
    version with the gate activation ``gate`` at each (T, B, masked) of
    ``cases`` (default: full width and decode) in each of ``dtypes``; at
    the first case's [T, B] also the wrong products, which the limit must
    catch."""
    errs = {}
    for dtype in dtypes:
        for T, B, masked in cases:
            args = seq_inputs(torch, T, B, H, dtype, masked, SEED + T + B)
            if masked:
                got = ls.fused_lstm_sequence_masked(*args, "tanh", gate)
                want = ls.lstm_sequence_masked_reference(*args, "tanh", gate)
            else:
                got = ls.fused_lstm_sequence(*args, "tanh", gate)
                want = ls.lstm_sequence_reference(*args, "tanh", gate)
            torch.cuda.synchronize()
            err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            name = "lstm_seq_lean_masked" if masked else "lstm_seq_lean"
            emit("kernel_vs_plain", kernel=name, dtype=dtype, T=T, B=B, H=H, gate=gate,
                 max_abs_err=err, atol=KERNEL_ATOL[dtype], finite=finite)
            if not finite or err > KERNEL_ATOL[dtype]:
                raise AssertionError(f"{name} {dtype} T={T} B={B} gate={gate}: max abs err "
                                     f"{err} > {KERNEL_ATOL[dtype]} or not finite")
            errs[(name, dtype, T, B)] = err
            if (T, B) == cases[0][:2]:  # the limit must catch wrong products
                zx, mask, rest = (args[0], args[1], args[2:]) if masked else (
                    args[0], None, args[1:])
                fwd_faults_caught(
                    name, dtype, lambda product: ls.lstm_sequence_masked_reference(
                        zx, mask, *rest, "tanh", gate, product),
                    want, lambda got, ref: ({"max_abs_err": max_abs(got, ref)},
                                            max_abs(got, ref) <= KERNEL_ATOL[dtype]),
                    dict(T=T, B=B, H=H, gate=gate, limit=KERNEL_ATOL[dtype]))
    return errs


def check(name: str, dtype: str, errs: dict, tol: dict, **fields) -> float:
    """Emit one kernel_vs_plain line for the per-output errors ``errs`` and
    raise past the limit of each output's dtype (``tol``: output -> (err
    limit)). Returns the largest error."""
    bad = {k: (e, tol[k]) for k, e in errs.items()
           if not (e <= tol[k])}  # NaN fails too
    emit("kernel_vs_plain", kernel=name, dtype=dtype, max_err_by_output=errs,
         limit_by_output=tol, ok=not bad, **fields)
    if bad:
        raise AssertionError(f"{name} {dtype} {fields}: outside the limits {bad}")
    return max(errs.values())


def bf16_readings(T: int, names, got, want):
    """A bf16 LSTM training kernel's outputs against its plain version's:
    each output, and each gate column of dzx, by max |err| / max |ref| and
    mean |err| / mean |ref|. Returns (readings, the BF16_TRAIN_REL limits of
    T, the readings past them)."""
    parts = []
    for n, g, w in zip(names, got, want):
        parts.append((n, g, w))
        if n == "dzx":
            H = g.shape[-1] // 4
            parts += [(f"{n}_{k}", gc, wc) for k, gc, wc in
                      zip("afoi", g.split(H, -1), w.split(H, -1))]
    lim = BF16_TRAIN_REL["tail" if T <= TAIL else "long"]
    readings, bad = {}, {}
    for n, g, w in parts:
        err, ref = (g.float() - w.float()).abs(), w.float().abs()
        r = {"max_rel": float(err.max() / ref.max()),
             "mean_rel": float(err.mean() / ref.mean()),
             "max_abs_ref": float(ref.max())}
        readings[n] = r
        if not (r["max_rel"] <= lim["max"] and r["mean_rel"] <= lim["mean"]):
            bad[n] = r  # NaN fails too
    return readings, lim, bad


def check_rel(name: str, T: int, names, got, want, **fields) -> None:
    """A bf16 LSTM training kernel against its plain version
    (``bf16_readings``, BF16_TRAIN_REL). Emits one kernel_vs_plain line with
    the readings, the limits and max |ref| beside them, and raises past a
    limit. ``fields`` (default: the char-RNN's B and H) go on the line."""
    readings, lim, bad = bf16_readings(T, names, got, want)
    emit("kernel_vs_plain", kernel=name, dtype="bfloat16", T=T,
         **(fields or dict(B=BATCH, H=HIDDEN)),
         relative_by_output=readings, limit_max_rel=lim["max"],
         limit_mean_rel=lim["mean"], ok=not bad)
    if bad:
        raise AssertionError(f"{name} bfloat16 T={T}: outside the limits {lim}: {bad}")


def f32_bwd_readings(got, want) -> dict:
    """Rows 7 and 9 in f32 against the plain version: max abs error of dzx,
    dh0 and dc0; of dRW and the peephole grads over their largest element."""
    e = {}
    for n, g, w in zip(BWD_NAMES, got, want):
        diff = float((g.float() - w.float()).abs().max())
        e[n] = diff / float(w.float().abs().max()) if n in SUMMED_GRADS else diff
    return e


def tf32(x):
    """x (f32) rounded to tf32 as cvt.rna rounds: to nearest, ties away."""
    import torch

    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


# the LSTM kernels' per-step products done wrong, each of which must read
# past the limits: the first k chunk of every block left out (a chunk of a
# row of the left operand, lstm_mma.cuh's: 1024 bytes in the backward of
# rows 7 and 9, kChunk; 512 in the forward step of rows 1, 5, 6 and 8,
# kFwdChunkBytes); in f32, one TF32 product in place of 3xTF32
PRODUCT_FAULTS = {"float32": ("k_chunk_dropped", "one_tf32_pass"),
                  "bfloat16": ("k_chunk_dropped",)}
BWD_CHUNK_BYTES, FWD_CHUNK_BYTES = 1024, 512
# the dRW product done wrong (the ``drw`` hook of the plain backwards), each
# of which must read past the limits: the first r tile of R left out (128
# bytes of a column, lstm_drw.cuh's kDrwTileBytes: 32 rows in f32, 64 in
# bf16); in f32, one TF32 product in place of 3xTF32
DRW_FAULTS = {"float32": ("drw_r_tile_dropped", "drw_one_tf32_pass"),
              "bfloat16": ("drw_r_tile_dropped",)}
DRW_TILE_BYTES = 128
# the dRW product alone against its plain version (phase_kernels_drw): R =
# T*B rows at B=64 for the cell's one step, the TBPTT tail, a TBPTT segment
# and a whole sequence; H=130 and 129 start rows of h only 8- (f32) or
# 4-byte (bf16) and 4- or 2-byte aligned (the 4-byte and element copies).
# f32 at the f32 limit over dRW's largest element, bf16 at the short
# sequences' relative limits (dRW is rounded once from an f32 sum)
DRW_CASES = [(T, H) for H in (HIDDEN, 130, 129) for T in (1, TAIL, TBPTT, STEPS)]


def product_fault(fault: str, dtype: str, chunk_bytes: int):
    """``product(a, b)`` = a @ b (both in f32, k the last axis of a) for a
    plain version, with ``fault``."""
    chunk = chunk_bytes // (4 if dtype == "float32" else 2)

    def product(a, b):
        if fault == "k_chunk_dropped":
            a = a.clone()
            a[..., :chunk] = 0.0
            return a @ b
        return tf32(a) @ tf32(b)

    return product


def drw_fault(fault: str, dtype: str):
    """``drw(h0, ys, dzx)`` = dRW (as the plain backwards' ``drw`` hook takes
    it) with ``fault`` of DRW_FAULTS, from the f32 product of the stacked
    rows."""
    import torch

    rows = DRW_TILE_BYTES // (4 if dtype == "float32" else 2)

    def drw(h0, ys, dzx):
        H = h0.shape[-1]
        hp = torch.cat([h0[None], ys[:dzx.shape[0] - 1]]).reshape(-1, H).float()
        dz = dzx.reshape(-1, 4 * H).float()
        if fault == "drw_r_tile_dropped":
            hp = hp.clone()
            hp[:rows] = 0.0
        else:
            hp, dz = tf32(hp), tf32(dz)
        return (hp.t() @ dz).to(dzx.dtype)

    return drw


def fwd_faults_caught(name: str, dtype: str, wrong_fn, want, limit, fields) -> None:
    """``wrong_fn(product)`` (the plain forward) with each wrong product of
    PRODUCT_FAULTS, read against ``want`` (the right plain version's
    outputs) as the kernel is, by ``limit(got, want)`` (a dict of
    readings and whether they are within the limit): emits one
    kernel_limits line and raises unless every one reads past the limit."""
    wrong = {}
    for fault in PRODUCT_FAULTS[dtype]:
        readings, within_limit = limit(
            wrong_fn(product_fault(fault, dtype, FWD_CHUNK_BYTES)), want)
        wrong[fault] = {"readings": readings, "caught": not within_limit}
    ok = all(w["caught"] for w in wrong.values())
    emit("kernel_limits", kernel=name, dtype=dtype, wrong_readings=wrong, caught=ok, **fields)
    if not ok:
        raise AssertionError(f"{name} {dtype}: the limits do not catch {wrong}")


def max_abs(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))


def train_mask(torch, T: int, dtype: str, seed: int, B: int = BATCH):
    """A [T, B, 1] features mask with every pattern a padded batch and its
    TBPTT segments give, and more: row 0 all zeros, row 1 leading zeros,
    row 2 an interior gap, the other rows ragged lengths (trailing zeros)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lengths = rng.integers(max(1, T // 3), T + 1, B)
    rows = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float64)
    rows[0] = 0.0
    rows[1, :max(1, T // 4)] = 0.0
    rows[2, T // 3:max(T // 3 + 1, T // 2)] = 0.0
    return torch.as_tensor(rows.T[..., None], dtype=getattr(torch, dtype),
                           device=DEVICE).contiguous()


def phase_kernels_train(torch, ls, sx):
    """The training kernels against their plain versions on the same CUDA
    tensors: rows 6 and 8 (unmasked and masked training forward) on every
    output including the residuals, rows 7 and 9 on all seven grads from
    random upstream grads, at T=256, T=50 and the 6-step tail, rows 8-9 with
    a mask of all zeros, leading, interior and trailing zeros
    (``train_mask``), and at T=50 the wrong products of rows 7 and 9
    (``bwd_faults_caught``); rows 10-11 at both row counts with one-hot and
    soft labels and at the other ``SXENT_CASES``, f32 and bf16 inputs.
    Returns the max abs error of each (kernel, dtype, size)."""
    errs = {}
    for dtype in ("float32", "bfloat16"):
        for T in (STEPS, TBPTT, TAIL):
            for masked in (False, True):
                errs.update(train_rows_case(torch, ls, dtype, T, masked,
                                            faults=T == TBPTT and not masked))
        for N, C in SXENT_CASES:
            for labels in ("one_hot", "soft") if C == VOCAB else ("one_hot",):
                e = sxent_case(torch, sx, N, C, dtype, labels, SEED + N + C)
                if C != VOCAB:
                    continue
                for name, keys in (("softmax_xent_fwd", ("loss",)),
                                   ("softmax_xent_bwd", ("dx", "dl"))):
                    key = (name, dtype, N)
                    errs[key] = max(errs.get(key, 0.0), max(e[k] for k in keys))
    return errs


def train_rows_case(torch, ls, dtype, T, masked, B=BATCH, H=HIDDEN, gate="sigmoid",
                    faults=False) -> dict:
    """Rows 6 and 8 (unmasked or masked training forward) on every output
    including the residuals, then rows 7 or 9 on all seven grads from
    random upstream grads, at [T, B, H] with the gate activation ``gate``,
    each against its plain version (bf16 by ``check_rel``), the mask
    ``train_mask``'s; with ``faults``, the wrong products of the backward
    (``bwd_faults_caught``). Returns the max abs error of each (kernel,
    dtype, T)."""
    import numpy as np

    dt, lim = getattr(torch, dtype), KERNEL_ATOL[dtype]
    fwd, bwd = (("lstm_seq_masked_train_fwd", "lstm_seq_masked_bwd") if masked
                else ("lstm_seq_train_fwd", "lstm_seq_bwd"))
    shape = dict(B=B, H=H, gate=gate)
    args = seq_inputs(torch, T, B, H, dtype, False, SEED + 7 * T)
    mask = train_mask(torch, T, dtype, SEED + T, B) if masked else None
    got = ls.lstm_sequence_masked_train_forward(args[0], mask, *args[1:], "tanh", gate)
    want = ls.lstm_sequence_masked_train_reference(args[0], mask, *args[1:], "tanh", gate)
    torch.cuda.synchronize()
    names = ("ys", "a", "f", "o", "i", "c", "hT", "cT")
    errs = {(fwd, dtype, T): max_abs(got, want)}
    if dtype == "bfloat16":
        check_rel(fwd, T, names, got, want, **shape)
    else:
        e = {n: float((g.float() - w.float()).abs().max()) for n, g, w in zip(names, got, want)}
        check(fwd, dtype, e, dict.fromkeys(e, lim), T=T, **shape)
    rng = np.random.default_rng(SEED + T)
    up = [torch.as_tensor(rng.normal(0.0, 0.1, s), dtype=dt, device=DEVICE)
          for s in ((T, B, H), (B, H), (B, H))]
    res = tuple(want[:6]) + tuple(args[1:])
    got = ls.lstm_sequence_masked_backward(*up, mask, *res, "tanh", gate)
    ref = ls.lstm_sequence_masked_backward_reference(*up, mask, *res, "tanh", gate)
    torch.cuda.synchronize()
    errs[(bwd, dtype, T)] = max_abs(got, ref)
    if dtype == "bfloat16":
        check_rel(bwd, T, BWD_NAMES, got, ref, **shape)
    else:
        e = f32_bwd_readings(got, ref)
        check(bwd, dtype, e, dict.fromkeys(e, lim), T=T, **shape,
              summed_grads_relative_to_largest=list(SUMMED_GRADS))
    if faults:
        bwd_faults_caught(ls, dtype, T, up, res, ref, gate=gate, B=B, H=H)
    return errs


def bwd_faults_caught(ls, dtype, T, up, res, ref, gate="sigmoid", B=BATCH, H=HIDDEN) -> None:
    """The plain backward with each wrong product of PRODUCT_FAULTS and
    each wrong dRW product of DRW_FAULTS, read against the right one as the
    kernel is: emits one kernel_limits line and raises unless every one
    reads past the limits."""
    wrong = {}
    for fault in PRODUCT_FAULTS[dtype] + DRW_FAULTS[dtype]:
        hook = ({"drw": drw_fault(fault, dtype)} if fault in DRW_FAULTS[dtype] else
                {"product": product_fault(fault, dtype, BWD_CHUNK_BYTES)})
        got = ls.lstm_sequence_masked_backward_reference(*up, None, *res, "tanh", gate, **hook)
        if dtype == "bfloat16":
            readings, _, bad = bf16_readings(T, BWD_NAMES, got, ref)
            wrong[fault] = {"outputs_past_limits": sorted(bad),
                            "worst_max_rel": max(r["max_rel"] for r in readings.values())}
            caught = bool(bad)
        else:
            e = f32_bwd_readings(got, ref)
            wrong[fault] = {"worst": max(e.values()), "by_output": e}
            caught = wrong[fault]["worst"] > KERNEL_ATOL[dtype]
        wrong[fault]["caught"] = caught
    ok = all(w["caught"] for w in wrong.values())
    emit("kernel_limits", kernel="lstm_seq_bwd", dtype=dtype, T=T, B=B, H=H, gate=gate,
         limit=KERNEL_ATOL[dtype] if dtype == "float32" else BF16_TRAIN_REL["long"],
         wrong_readings=wrong, caught=ok)
    if not ok:
        raise AssertionError(f"lstm_seq_bwd {dtype}: the limits do not catch {wrong}")


def drw_inputs(torch, T, H, dtype, seed, B=BATCH):
    """(h0 [B, H], ys [T, B, H], dzx [T, B, 4H]) of one dRW product on the
    card from a numpy seed, scaled as the training backward's (h in
    (-1, 1), gate grads ~1e-2)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    arrs = (np.tanh(rng.normal(0.0, 1.0, (B, H))),
            np.tanh(rng.normal(0.0, 1.0, (T, B, H))),
            rng.normal(0.0, 1e-2, (T, B, 4 * H)))
    return [torch.as_tensor(a, dtype=getattr(torch, dtype), device=DEVICE) for a in arrs]


def drw_within(r: dict, dtype: str) -> bool:
    """dRW's reading (``rel_readings``) within its limit: f32 max |err| over
    its largest element, bf16 the short sequences' relative limits."""
    if dtype == "float32":
        return r["max_rel"] <= KERNEL_ATOL[dtype]  # NaN fails too
    lim = BF16_TRAIN_REL["tail"]
    return r["max_rel"] <= lim["max"] and r["mean_rel"] <= lim["mean"]


def phase_kernels_drw(torch, ls):
    """The dRW product alone (``drw_product``) against its plain version on
    the same CUDA tensors at every (T, H) of DRW_CASES, f32 and bf16, one
    line each; at T=256, H=512 also the wrong products of DRW_FAULTS, which
    the limits must catch. Returns the max abs error at T=256, H=512 by
    dtype (the kernels line takes f32's)."""
    errs = {}
    for dtype in ("float32", "bfloat16"):
        for T, H in DRW_CASES:
            h0, ys, dzx = drw_inputs(torch, T, H, dtype, SEED + T + H)
            got = ls.drw_product(h0, ys, dzx)
            want = ls.drw_product_reference(h0, ys, dzx)
            torch.cuda.synchronize()
            r = rel_readings([got], [want], ["dRW"])["dRW"]
            ok = got.shape == (H, 4 * H) and got.dtype == want.dtype and drw_within(r, dtype)
            fields = dict(kernel="drw_product", dtype=dtype, T=T, B=BATCH, R=T * BATCH, H=H,
                          slices=ls.drw_slices(T * BATCH, H), readings=r,
                          limit=(KERNEL_ATOL[dtype] if dtype == "float32"
                                 else BF16_TRAIN_REL["tail"]))
            emit("kernel_vs_plain", ok=ok, **fields)
            if not ok:
                raise AssertionError(f"drw_product {dtype} T={T} H={H}: {r} outside the limit")
            if (T, H) == (STEPS, HIDDEN):
                errs[dtype] = r["max_abs"]
                wrong = {}
                for fault in DRW_FAULTS[dtype]:
                    wr = rel_readings([drw_fault(fault, dtype)(h0, ys, dzx)], [want],
                                      ["dRW"])["dRW"]
                    wrong[fault] = {"readings": wr, "caught": not drw_within(wr, dtype)}
                caught = all(w["caught"] for w in wrong.values())
                emit("kernel_limits", kernel="drw_product", dtype=dtype, T=T, B=BATCH, H=H,
                     limit=fields["limit"], wrong_readings=wrong, caught=caught)
                if not caught:
                    raise AssertionError(f"drw_product {dtype}: the limits do not catch {wrong}")
    return errs


def kernel_device_ms(torch, fn, pattern: str, calls: int = 10):
    """ms a call of ``fn`` spends on the card in the kernels whose names match
    ``pattern`` (``calls`` calls under the profiler), or None where three
    tries of the profiler reported none of them (it has dropped a window's
    device events now and then)."""
    for _ in range(3):
        groups = profile(torch, lambda: [fn() for _ in range(calls)],
                         groups=[("kernels", pattern)])["groups"]
        if "kernels" in groups:
            return groups["kernels"][0] / calls
    return None


def bound_drw(R: int, H: int, dtype: str):
    """The dRW product over R rows: h_prev [R, H] and dzx [R, 4H] read,
    dRW [H, 4H] written; 2*R*H*4H operations at the tensor cores' peak (f32
    at the 3xTF32 rate)."""
    item = 4 if dtype == "float32" else 2
    return roofline((R * H + R * 4 * H + H * 4 * H) * item, 2.0 * R * H * 4 * H, dtype,
                    tc_rate(dtype))


def time_drw(torch, ls, card):
    """The dRW product at the sequence backward's R = 16384 (T=256, B=64)
    and the cell's R = 64, H=512, both dtypes, beside its plain version, its
    bound, its time on the card (10 calls under the profiler) and
    torch.matmul(hp.t(), dz) over the same rows stacked contiguous (the
    library yardstick; f32 without TF32)."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        for T in (STEPS, 1):
            h0, ys, dzx = drw_inputs(torch, T, HIDDEN, dtype, SEED)
            hp = torch.cat([h0[None], ys[:T - 1]]).reshape(-1, HIDDEN).contiguous()
            dz = dzx.reshape(-1, 4 * HIDDEN).contiguous()
            R = T * BATCH

            def call(h0=h0, ys=ys, dzx=dzx):
                return ls.drw_product(h0, ys, dzx)

            device_ms = kernel_device_ms(torch, call, r"drw_mma|drw_reduce")
            t = time_pair(torch, "drw_product", call,
                          lambda h0=h0, ys=ys, dzx=dzx: ls.drw_product_reference(h0, ys, dzx),
                          lambda hp=hp, dz=dz: torch.matmul(hp.t(), dz),
                          *bound_drw(R, HIDDEN, dtype), card, dtype=dtype, T=T, B=BATCH, R=R,
                          H=HIDDEN, slices=ls.drw_slices(R, HIDDEN), kernel_device_ms=device_ms)
            t["kernel_device_ms"] = device_ms
            out[(dtype, R)] = t
    return out


def sxent_case(torch, sx, N, C, dtype, labels, seed) -> dict:
    """Rows 10-11 against their plain versions at [N, C] (loss, dx, dl from
    a random g): f32 outputs at the f32 limit, bf16 ones at one bf16 step
    of values below 1. Emits the kernel_vs_plain line; returns the errors."""
    import numpy as np

    x, lab = sxent_inputs(torch, N, dtype, labels, seed, C=C)
    g = torch.as_tensor(np.random.default_rng(seed).normal(0.0, 1.0, N),
                        dtype=torch.float32, device=DEVICE)
    out = {"loss": (sx.fused_softmax_xent(x, lab), sx.softmax_xent_reference(x, lab))}
    for n, k, w in zip(("dx", "dl"), sx.softmax_xent_backward(x, lab, g),
                       sx.softmax_xent_backward_reference(x, lab, g)):
        out[n] = (k, w)
    torch.cuda.synchronize()
    e = {n: float((k.float() - w.float()).abs().max()) for n, (k, w) in out.items()}
    tol = {n: KERNEL_ATOL["float32"] if k.dtype == torch.float32 else 2.0 ** -8
           for n, (k, _) in out.items()}
    check("softmax_xent", dtype, e, tol, N=N, C=C, labels=labels)
    return e


def time_pair(torch, name, kern, plain, lib, b_ms, b_by, card, **fields):
    """Time ``kern`` and ``plain`` (plain, kernel, kernel, plain; the lesser
    median of each) and ``lib`` twice; emit one time_kernel line and return
    the kernels-line numbers."""
    plain_1, ms_1 = median_ms(plain, **PLAIN_REPS), median_ms(kern)
    ms_2, plain_2 = median_ms(kern), median_ms(plain, **PLAIN_REPS)
    lib_runs = [median_ms(lib), median_ms(lib)] if lib is not None else None
    emit("time_kernel", kernel=name, ms_runs=[ms_1, ms_2], plain_ms_runs=[plain_1, plain_2],
         library_ms_runs=lib_runs, bound_ms=b_ms, bound_by=b_by, gpu=card, **fields)
    return dict(ms=min(ms_1, ms_2), plain_ms=min(plain_1, plain_2), bound_ms=b_ms,
                bound_by=b_by, library_ms=min(lib_runs) if lib_runs else None)


def time_adam(torch, ad, card, shapes=None, what="the char-RNN's 14 leaves", dev=False):
    """Row 12 over ``shapes``' leaves (default: the char-RNN's 14; one
    update: one grouped call, one launch) beside its plain version leaf by
    leaf, its bound and torch.optim.Adam(fused=True).step() on the same
    leaves as the library yardstick (it also adds u to the params). The
    gradients of convolution weights come in the strides of the main path
    (``conv_grad_layout``), so the wrapper's copy of them is in the time.
    With ``dev``, the device-scalar entry, lr, bc1 and bc2 in a tensor on
    the card (its plain version takes them as 0-d tensors there)."""
    leaves, sc = adam_inputs(torch, SEED + 1, shapes)
    leaves = conv_grad_layout(leaves)
    gs, ms, vs = (list(x) for x in zip(*leaves))
    params = [torch.nn.Parameter(torch.zeros_like(g)) for g in gs]
    for p, g in zip(params, gs):
        p.grad = g
    opt = torch.optim.Adam(params, lr=sc[0], betas=(sc[3], sc[4]), eps=sc[5], fused=True)
    n = sum(g.numel() for g in gs)

    row = torch.tensor(sc[:3], dtype=torch.float32, device=DEVICE)

    def call():
        if dev:
            return ad.fused_adam_update_leaves_dev(gs, ms, vs, row, *sc[3:])
        return ad.fused_adam_update_leaves(gs, ms, vs, *sc)

    def plain():
        scalars = (row[0], row[1], row[2]) if dev else sc[:3]
        return [ad.adam_update_reference(g, m, v, *scalars, *sc[3:]) for g, m, v in leaves]

    # the kernel's own time on the card, apart from the host's part of a call
    prof = profile(torch, lambda: [call() for _ in range(10)])
    adam_rows = [r[1] for r in prof["top_kernels"] if "adam_multi" in r[0]]
    # None where the profiler caught no adam kernel in the window (it
    # sometimes records no device event for so short a window)
    device_ms = sum(adam_rows) / 10 if adam_rows else None
    emit("profile", what=f"10 grouped Adam calls over {what}" + (
        ", device-scalar entry" if dev else ""), gpu=card,
         adam_multi_device_ms_per_call=device_ms, **prof)
    t = time_pair(
        torch, "adam_update_dev" if dev else "adam_update", call, plain,
        opt.step, *bound_adam(n), card, dtype="float32", over=what, leaves=len(leaves),
        elements=n,
        launches_per_call=-(-len(leaves) // ad.MAX_LEAVES), kernel_device_ms=device_ms)
    t["kernel_device_ms"] = device_ms
    return t


def time_train_kernels(torch, ls, sx, card):
    """ms of each training kernel at the main path's shapes (T=256, B=64;
    N=B*T rows; rows 8-9 with ``train_mask``) beside its plain version, its
    bound and, for rows 10-11, the one PyTorch call that computes the same
    function (cross_entropy with probability targets: forward, and forward
    plus backward into both inputs)."""
    import numpy as np
    import torch.nn.functional as F

    times = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        args = seq_inputs(torch, STEPS, BATCH, HIDDEN, dtype, False, SEED)
        res = ls.lstm_sequence_train_reference(*args)
        rng = np.random.default_rng(SEED)
        up = [torch.as_tensor(rng.normal(0.0, 0.1, shape), dtype=dt, device=DEVICE)
              for shape in ((STEPS, BATCH, HIDDEN), (BATCH, HIDDEN), (BATCH, HIDDEN))]
        res = tuple(res[:6]) + tuple(args[1:])
        N = SXENT_ROWS[0]
        x, lab = sxent_inputs(torch, N, dtype, "one_hot", SEED)
        g = torch.as_tensor(rng.normal(0.0, 1.0, N), dtype=torch.float32, device=DEVICE)
        xg, lg = x.clone().requires_grad_(), lab.clone().requires_grad_()
        gl = g.to(dt)

        def lib_fwd_bwd():
            xg.grad = lg.grad = None
            F.cross_entropy(xg, lg, reduction="none").backward(gl)

        mask = train_mask(torch, STEPS, dtype, SEED + STEPS)
        mres = ls.lstm_sequence_masked_train_reference(args[0], mask, *args[1:])
        mres = tuple(mres[:6]) + tuple(args[1:])
        live = live_share(mask)
        cases = (
            ("lstm_seq_train_fwd", lambda: ls.lstm_sequence_train_forward(*args),
             lambda: ls.lstm_sequence_train_reference(*args), None,
             bound_train_fwd(STEPS, BATCH, HIDDEN, dtype)),
            ("lstm_seq_bwd", lambda: ls.lstm_sequence_backward(*up, *res),
             lambda: ls.lstm_sequence_backward_reference(*up, *res), None,
             bound_bwd(STEPS, BATCH, HIDDEN, dtype)),
            ("lstm_seq_masked_train_fwd",
             lambda: ls.lstm_sequence_masked_train_forward(args[0], mask, *args[1:]),
             lambda: ls.lstm_sequence_masked_train_reference(args[0], mask, *args[1:]), None,
             bound_train_fwd(STEPS, BATCH, HIDDEN, dtype, masked=True)),
            ("lstm_seq_masked_bwd", lambda: ls.lstm_sequence_masked_backward(*up, mask, *mres),
             lambda: ls.lstm_sequence_masked_backward_reference(*up, mask, *mres), None,
             bound_bwd(STEPS, BATCH, HIDDEN, dtype, live=live, masked=True)),
            ("softmax_xent_fwd", lambda: sx.fused_softmax_xent(x, lab),
             lambda: sx.softmax_xent_reference(x, lab),
             lambda: F.cross_entropy(x, lab, reduction="none"),
             bound_sxent(N, VOCAB, dtype, False)),
            ("softmax_xent_bwd", lambda: sx.softmax_xent_backward(x, lab, g),
             lambda: sx.softmax_xent_backward_reference(x, lab, g), lib_fwd_bwd,
             bound_sxent(N, VOCAB, dtype, True)),
        )
        device_ms = sxent_device_ms(torch, sx, x, lab, g, card, dtype)
        for name, kern, plain, lib, (b_ms, b_by) in cases:
            extra = {"kernel_device_ms": device_ms[name]} if name in device_ms else {}
            times[(name, dtype)] = time_pair(
                torch, name, kern, plain, lib, b_ms, b_by, card, dtype=dtype, T=STEPS,
                B=BATCH, H=HIDDEN, N=N, C=VOCAB,
                mask_live_share=live if "masked" in name else None, **extra)
            times[(name, dtype)].update(extra)
        if dtype == "float32":  # where one forward and one backward call's card time goes
            emit("profile", what="one lstm_sequence_train_forward call, f32 T=256 B=64 H=512",
                 gpu=card, **profile(torch, cases[0][1], groups=LSTM_PROFILE_GROUPS))
            emit("profile", what="one lstm_sequence_backward call, f32 T=256 B=64 H=512",
                 gpu=card, **profile(torch, cases[1][1], groups=BWD_PROFILE_GROUPS))
    return times


# rows 7 and 9's kernels, for the profile's split of one backward call
BWD_PROFILE_GROUPS = [("step kernel (T launches)", r"lstm_bwd_step"),
                      ("dh0 product", r"lstm_bwd_dh"),
                      ("dRW product (drw_mma, drw_reduce)", r"drw_mma|drw_reduce"),
                      ("peephole_reduce", r"peephole_reduce")]
# the LSTM's kernels, for the profiles' split of a training forward, an
# update or an output() (the forward step of rows 1, 5, 6 and 8 first)
LSTM_PROFILE_GROUPS = [("forward step (rows 1, 5, 6, 8)", r"lstm_step_mma"),
                       ("backward step (rows 7, 9)", r"lstm_bwd_step"),
                       ("dh product (dh0; row 2's dh_prev)", r"lstm_bwd_dh"),
                       ("cell_bwd_gates (row 2)", r"cell_bwd_gates"),
                       ("dRW product (drw_mma, drw_reduce)", r"drw_mma|drw_reduce"),
                       ("peephole_reduce", r"peephole_reduce"),
                       ("softmax_xent", r"softmax_xent"), ("adam", r"adam")]


def sxent_device_ms(torch, sx, x, lab, g, card, dtype) -> dict:
    """Rows 10 and 11's own time on the card a call (10 calls of each under
    the profiler, apart from the host's part of a call), and cross_entropy's
    kernels over 10 calls beside them; emits one profile line each."""
    import torch.nn.functional as F

    out = {}
    for name, call, rx in (
            ("softmax_xent_fwd", lambda: sx.fused_softmax_xent(x, lab), r"sxent_fwd"),
            ("softmax_xent_bwd", lambda: sx.softmax_xent_backward(x, lab, g), r"sxent_bwd"),
            ("cross_entropy", lambda: F.cross_entropy(x, lab, reduction="none"), r".")):
        for _ in range(3):  # the profiler at times records none of a call's kernels
            prof = profile(torch, lambda: [call() for _ in range(10)], groups=[(name, rx)])
            if name in prof["groups"]:
                break
        out[name] = prof["groups"][name][0] / 10 if name in prof["groups"] else None
        emit("profile", what=f"10 calls of {name}, {dtype} N={x.shape[0]} C={x.shape[1]}",
             gpu=card, device_ms_per_call=out[name], **prof)
    return out


def sxent_inputs(torch, N, dtype, labels, seed, C=VOCAB):
    """Logits [N, C] and one-hot or soft (softmax of random) labels, both
    in ``dtype``, on the card from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 2.0, (N, C))
    if labels == "one_hot":
        lab = np.eye(C)[rng.integers(0, C, N)]
    else:
        z = rng.normal(0.0, 1.0, (N, C))
        lab = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
    dt = getattr(torch, dtype)
    return (torch.as_tensor(x, dtype=dt, device=DEVICE).contiguous(),
            torch.as_tensor(lab, dtype=dt, device=DEVICE).contiguous())


def adam_inputs(torch, seed, shapes=None):
    """One (g, m, v) f32 triple on the card per leaf of ``shapes`` (default:
    the param leaves of the full-width char-RNN, 14 leaves, 3,398,752
    elements), from a numpy seed, and the scalars (lr, bc1, bc2, b1, b2,
    eps) of its third Adam update."""
    import numpy as np

    from deeplearning4j_tpu_torch import char_rnn
    from deeplearning4j_tpu_torch.nn.updaters import bias_corrections

    if shapes is None:
        shapes = [np.shape(layer[k]) for layer in char_rnn_params(
            char_rnn(VOCAB, HIDDEN, LAYERS), seed) for k in sorted(layer)]
    rng = np.random.default_rng(seed)
    leaves = []
    for shape in shapes:
        arrs = (rng.normal(0.0, 1e-2, shape), rng.normal(0.0, 1e-3, shape),
                np.abs(rng.normal(0.0, 1e-4, shape)))
        leaves.append(tuple(torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
                            for a in arrs))
    bc1, bc2 = bias_corrections(3, 0.9, 0.999, torch.float32)
    return leaves, (RECIPE_LR, bc1, bc2, 0.9, 0.999, 1e-8)


def conv_grad_layout(leaves):
    """(g, m, v) triples, each 4-D g [kh, kw, c_in, c_out] (a convolution's
    weight gradient) with the same values in the strides that the
    convolution's backward gives it: stored as [c_out, kh, kw, c_in], the
    channels-last layout of torch's [c_out, c_in, kh, kw]."""
    return [(g.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0) if g.dim() == 4 else g,
             m, v) for g, m, v in leaves]


def adam_cases(torch, ad):
    """Row 12's cases, each one grouped call, as (name, leaves, launches it
    must make), and the Adam scalars. The char-RNN's 14 leaves and the
    attention net's 16; an edge list (sizes 1, 3, 5, 1023, 4097, a leaf of
    2^20 + 3 elements, and a leaf that starts one float into its storage,
    which takes the scalar route); and MAX_LEAVES + 5 leaves, two
    launches; LeNet's 8 leaves (its convolutions' gradients in the main
    path's strides) and the MNIST MLP's 4; the leaves of slice 16's nets
    (``real_data_adam_shapes``)."""
    import numpy as np

    leaves, sc = adam_inputs(torch, SEED)
    attention = [np.shape(a) for layer in attention_params(SEED) for _, a in sorted(
        layer.items())]
    attn_leaves, _ = adam_inputs(torch, SEED + 2, attention)
    edge, _ = adam_inputs(torch, SEED + 3, [(1,), (3,), (5,), (1023,), (4097,), (2 ** 20 + 3,),
                                            (3, 7), (1025,)])
    edge[-1] = tuple(t[1:] for t in edge[-1])  # one float in: not 16-byte aligned
    many, _ = adam_inputs(torch, SEED + 4, [(37 * (i + 1),) for i in range(ad.MAX_LEAVES + 5)])
    mnist = [(name, conv_grad_layout(adam_inputs(torch, SEED + 5 + i,
                                                 mnist_leaf_shapes(conf))[0]), 1)
             for i, (name, (_, conf)) in enumerate(mnist_models().items())]
    real = [(name, conv_grad_layout(adam_inputs(torch, SEED + 9 + i, shapes)[0]), 1)
            for i, (name, shapes) in enumerate(real_data_adam_shapes().items())]
    return [("char_rnn", leaves, 1), ("attention", attn_leaves, 1), ("edge", edge, 1),
            ("more_than_max_leaves", many, 2), *mnist, *real], sc


def phase_adam(torch, ad):
    """Row 12 against its plain version (leaf by leaf) on ``adam_cases``:
    each output's max |err| over its max |ref| (ADAM_REL), and each grouped
    call's launches. Returns the max abs error of each case by name."""
    cases, sc = adam_cases(torch, ad)
    return {name: adam_check(torch, ad, name, leaves, sc, want_launches)
            for name, leaves, want_launches in cases}


def phase_kernels_mnist(torch, sx):
    """Rows 10-11 against their plain versions at the MNIST models' loss
    heads (N = 64 and 512 rows, C = 10; f32). Returns the errors by
    model."""
    return {name: sxent_case(torch, sx, B, 10, "float32", "one_hot", SEED + B)
            for name, (B, _) in mnist_models().items()}


class LossRecorder:
    """fit listener: keeps each update's loss tensor (read after the run)."""

    def __init__(self):
        self.losses = []

    def iteration_done(self, net, iteration, loss):
        self.losses.append(loss)


def char_batches(n: int, seed: int):
    """``n`` (x, y) batches of next-char prediction over learnable text: a
    sentence of SENTENCE characters drawn from the seed, repeated, each row
    starting at a random place in it. One-hot [BATCH, STEPS, VOCAB] each, y
    shifted one step from x."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sentence = rng.integers(0, VOCAB, SENTENCE)
    out = []
    for _ in range(n):
        start = rng.integers(0, SENTENCE, (BATCH, 1))
        seq = sentence[(start + np.arange(STEPS + 1)) % SENTENCE]
        out.append((one_hot(seq[:, :-1], VOCAB), one_hot(seq[:, 1:], VOCAB)))
    return out


def sgd_readings(run, ref, seed_params) -> dict:
    """An SGD run (net, losses, params) against a reference run: the losses
    of every update relative to the reference's, the largest absolute param
    difference, and each param tensor's change from the seed params relative
    to the norm of the reference's change, so an update left out reads 1."""
    import numpy as np

    _, losses, params = run
    _, ref_losses, ref_params = ref
    return {
        "loss_rel": float(np.max(np.abs(losses - ref_losses) / np.abs(ref_losses))),
        "param_abs": max(float(np.abs(p[k] - q[k]).max())
                         for p, q in zip(params, ref_params) for k in p),
        "change_rel": max(float(np.linalg.norm(p[k] - q[k])
                                / np.linalg.norm(q[k] - p0[k].astype(np.float32)))
                          for p, q, p0 in zip(params, ref_params, seed_params) for k in p),
    }


def phase_train(torch, mode, dtype, host_params, card):
    """Train the char-RNN from the seed params on the card and on the CPU
    from the same batches; hold the per-update losses, the final params and
    their change from the seed params against the CPU's, check that the loss
    fell and the launch counts of the card's run, then time more batches on
    the card. Returns (launch counts, ms per update, the card's net, the
    first batch)."""
    import numpy as np

    from deeplearning4j_tpu_torch import MultiLayerNetwork, char_rnn, load_jax_params
    from deeplearning4j_tpu_torch import ops

    conf = char_rnn(VOCAB, HIDDEN, LAYERS, tbptt_length=TBPTT, dtype=dtype)
    conf.updater = {"updater": "sgd", "learning_rate": LR}
    conf.backprop_type = mode
    compared = TRAIN_BATCHES[mode]
    batches = char_batches(compared + TIMED_BATCHES, SEED + 1)
    runs = {}
    for dev in ("cuda", "cpu"):
        net = load_jax_params(MultiLayerNetwork(conf, device=dev), host_params)
        rec = LossRecorder()
        net.set_listeners(rec)
        if dev == "cuda":
            torch.cuda.synchronize()
            ops.reset_counters()
        t0 = time.perf_counter()
        for x, y in batches[:compared]:
            net.fit((x, y))
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = ops.counters()
        seconds = time.perf_counter() - t0
        losses = np.array([float(l) for l in rec.losses])
        params = [{k: v.detach().float().cpu().numpy() for k, v in p.items()}
                  for p in net.layer_params]
        runs[dev] = (net, losses, params, seconds)
    net, losses, params, gpu_s = runs["cuda"]
    _, cpu_losses, cpu_params, cpu_s = runs["cpu"]
    updates = compared * UPDATES_PER_BATCH[mode]
    expected = dict.fromkeys(launches, 0)
    expected.update({"lstm_seq_train_fwd": LAYERS * updates,
                     "lstm_seq_bwd": LAYERS * updates, "drw_product": LAYERS * updates,
                     "softmax_xent_fwd": updates, "softmax_xent_bwd": updates})
    r = sgd_readings((net, losses, params), (None, cpu_losses, cpu_params), host_params)
    loss_err, param_err, step_err = r["loss_rel"], r["param_abs"], r["change_rel"]
    loss_fall = float(cpu_losses[0] - cpu_losses[-1])
    ok = (losses.shape == (updates,) and bool(np.isfinite(losses).all())
          and loss_err <= TRAIN_LOSS_RTOL[dtype] and param_err <= TRAIN_PARAM_ATOL[dtype]
          and step_err <= TRAIN_STEP_RTOL[dtype] and loss_fall > 0.0
          and launches == expected and net.iteration == updates)
    net.set_listeners()
    times = []
    for x, y in batches[compared:]:
        t0 = time.perf_counter()
        net.fit((x, y))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    batch_ms = statistics.median(times)
    ms_per_update = batch_ms / UPDATES_PER_BATCH[mode]
    emit(f"train_{mode}", dtype=dtype, batches=compared, updates=updates,
         losses=losses.tolist(), cpu_losses=cpu_losses.tolist(),
         max_loss_rel_err_vs_cpu=loss_err, loss_rtol=TRAIN_LOSS_RTOL[dtype],
         max_param_abs_err_vs_cpu=param_err, param_atol=TRAIN_PARAM_ATOL[dtype],
         max_param_change_rel_err_vs_cpu=step_err, change_rtol=TRAIN_STEP_RTOL[dtype],
         cpu_loss_fall=loss_fall, kernel_launches=launches, expected_launches=expected,
         first_batches_s=gpu_s, cpu_batches_s=cpu_s, timed_batch_ms_runs=times,
         ms_per_update=ms_per_update, chars_per_s=BATCH * STEPS / (batch_ms / 1e3),
         ok=ok, gpu=card)
    if not ok:
        raise AssertionError(f"training {mode} {dtype} failed its checks")
    return launches, ms_per_update, net, batches[0]


def recipe_sequences():
    """The recipe's text: (features [L, VOCAB], labels [L, VOCAB]) next-char
    pairs of the seeded sentence, RECIPE_SHORT lengths in 96..128 and
    RECIPE_LONG in 129..256 drawn from the seed, in shuffled order, each
    starting at a random place in the sentence."""
    import numpy as np

    rng = np.random.default_rng(SEED + 2)
    sentence = rng.integers(0, VOCAB, SENTENCE)
    lengths = np.concatenate([rng.integers(96, 129, RECIPE_SHORT),
                              rng.integers(129, 257, RECIPE_LONG)])
    rng.shuffle(lengths)
    out = []
    for n in lengths:
        seq = sentence[(rng.integers(0, SENTENCE) + np.arange(n + 1)) % SENTENCE]
        out.append((one_hot(seq[:-1], VOCAB), one_hot(seq[1:], VOCAB)))
    return out


def recipe_readings(run, ref, seed_params, lr=RECIPE_LR):
    """A recipe run on the card against the same run on the CPU: the losses
    of every update relative to the CPU's, each param tensor's change from
    the seed params relative to the norm of the CPU's change (an update left
    out reads 1), the largest absolute param difference, and the count of
    elements that differ by more than lr/10."""
    import numpy as np

    _, losses, params = run
    _, ref_losses, ref_params = ref
    diffs = [np.abs(p[k] - q[k]) for p, q in zip(params, ref_params) for k in p]
    return {
        "loss_rel": float(np.max(np.abs(losses - ref_losses) / np.abs(ref_losses))),
        "change_rel": max(float(np.linalg.norm(p[k] - q[k])
                                / np.linalg.norm(q[k] - p0[k].astype(np.float32)))
                          for p, q, p0 in zip(params, ref_params, seed_params) for k in p),
        "max_param_abs": max(float(d.max()) for d in diffs),
        "elements_over_lr_tenth": int(sum(int((d > lr / 10).sum()) for d in diffs)),
    }


def within_limits(readings: dict, limits: dict) -> bool:
    return all(readings[k] <= limits[k] for k in limits)  # NaN fails too


# The recipe on the card against the same recipe on the CPU. Adam makes each
# element's step about +-lr wherever the gradient's sign is uncertain: in
# bf16 compute, 2.3% of the 3.4M elements end more than lr/10 apart and the
# largest difference is 2.5 lr. So the params are held by their change
# relative to its norm and by counts, not elementwise at f32 precision.
# Limits per reading, between what the correct kernels read on the H100
# (f32: loss 3.6e-6, change 1.4e-5, max 1.0e-5, 0 elements; bf16: 5.0e-3,
# 0.027, 2.5e-3, 76,806 elements) and what a wrong Adam, b1 and b2 swapped
# or no bias correction, run on the card in the same phase reads (f32 and
# bf16 alike: loss 0.14-0.20, change 0.47-6.3, max 0.0067-0.049, 3.08M-3.28M
# elements); the phase fails if a wrong Adam passes.
RECIPE_LIMITS = {
    "float32": {"loss_rel": 5e-5, "change_rel": 1e-4, "max_param_abs": 2e-4,
                "elements_over_lr_tenth": 100},
    "bfloat16": {"loss_rel": 2e-2, "change_rel": 0.15, "max_param_abs": 5e-3,
                 "elements_over_lr_tenth": 500000},
}
# evaluate() accuracy, card against CPU, over the 24,576 rows of one epoch
# (read on the H100: f32 equal, bf16 1.2e-3 apart)
EVAL_ACC_ATOL = {"float32": 1e-3, "bfloat16": 1e-2}
RECIPE_FAULTS = ("adam_b1_b2_swapped", "no_bias_correction")


def phase_train_recipe(torch, dtype, host_params, card):
    """The char-RNN's own training recipe at full width from the seed params:
    ``fit`` over the bucketed, padded batches on the card and on the CPU,
    held by ``recipe_readings``; the card's launch counts exactly; the same
    run with a wrong Adam, which the limits must catch; ``evaluate`` on both;
    a checkpoint written on the card, restored on the card and on the CPU,
    the card's restored net continuing exactly as the original; then one
    timed epoch. Returns (launch counts, ms per update, the card's net, the
    iterator)."""
    import os
    import tempfile

    import numpy as np

    from deeplearning4j_tpu_torch import (BucketingSequenceIterator, MultiLayerNetwork,
                                          char_rnn, load_jax_params, ops, params_to_numpy,
                                          restore_model, write_model)

    conf = char_rnn(VOCAB, HIDDEN, LAYERS, dtype=dtype)
    assert (conf.updater["updater"], conf.updater["learning_rate"], conf.backprop_type,
            conf.tbptt_fwd_length, conf.tbptt_back_length) == (
                "adam", RECIPE_LR, "tbptt", TBPTT, TBPTT), conf.updater
    seqs = recipe_sequences()
    it = BucketingSequenceIterator(seqs, batch=BATCH, boundaries=RECIPE_BUCKETS)
    shapes = [ds.features.shape[:2] for ds in it]
    if sorted(shapes) != [(BATCH, 128), (BATCH, 256)]:
        raise AssertionError(f"recipe batches {shapes}")
    updates = sum(-(-t // TBPTT) for _, t in shapes)
    real_chars = sum(len(x) for x, _ in seqs)
    padded_chars = sum(b * t for b, t in shapes)

    def train(dev, fault=None):
        net = load_jax_params(MultiLayerNetwork(conf, device=dev), host_params)
        rec = LossRecorder()
        net.set_listeners(rec)
        undo = wrong_adam(net, fault)
        launches = None
        try:
            if dev == "cuda":
                torch.cuda.synchronize()
                ops.reset_counters()
            t0 = time.perf_counter()
            net.fit(it)
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = ops.counters()
            seconds = time.perf_counter() - t0
        finally:
            undo()
        net.set_listeners()
        losses = np.array([float(l) for l in rec.losses])
        return (net, losses, params_to_numpy(net)), launches, seconds

    gpu_run, launches, gpu_s = train("cuda")
    cpu, _, cpu_s = train("cpu")
    net, losses, _ = gpu_run
    cpu_losses = cpu[1]
    readings = recipe_readings(gpu_run, cpu, host_params)
    lim = RECIPE_LIMITS[dtype]
    within = within_limits(readings, lim)
    faults = {}
    for fault in RECIPE_FAULTS:
        faults[fault] = recipe_readings(train("cuda", fault)[0], cpu, host_params)
        faults[fault]["caught"] = not within_limits(faults[fault], lim)
    expected = dict.fromkeys(launches, 0)
    expected.update({"lstm_seq_masked_train_fwd": LAYERS * updates,
                     "lstm_seq_masked_bwd": LAYERS * updates, "drw_product": LAYERS * updates,
                     "softmax_xent_fwd": updates, "softmax_xent_bwd": updates,
                     "adam_update": updates * adam_launches(net)})
    loss_fall = float(cpu_losses[:3].mean() - cpu_losses[-3:].mean())

    # evaluate(): accuracy over every step of every padded row, as the JAX
    # package counts it
    evals = {dev: n.evaluate(it) for dev, n in (("cuda", net), ("cpu", cpu[0]))}
    acc = {dev: ev.accuracy() for dev, ev in evals.items()}
    acc_err = abs(acc["cuda"] - acc["cpu"])

    # checkpoint: written on the card, restored on the card and on the CPU;
    # the card's restored net and the original take the next batch alike
    first = next(iter(it))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "char_rnn.zip")
        write_model(net, path)
        back = restore_model(path)
        on_cpu = restore_model(path, device="cpu")
    restored_counts = {"written": [net.iteration, net.epoch],
                       "cuda": [back.iteration, back.epoch],
                       "cpu": [on_cpu.iteration, on_cpu.epoch]}
    cpu_restore_err = max(
        max(float(np.abs(p[k] - q[k]).max()) for p, q in
            zip(params_to_numpy(net), params_to_numpy(on_cpu)) for k in p),
        max(float((a.float().cpu() - b.float()).abs().max()) for a, b in
            zip(net.updater_state_leaves(), on_cpu.updater_state_leaves())))
    resumed = []
    for n in (net, back):
        rec = LossRecorder()
        n.set_listeners(rec)
        n.fit(first)
        n.set_listeners()
        resumed.append(([float(l) for l in rec.losses], params_to_numpy(n)))
    resume_err = max(float(np.abs(p[k] - q[k]).max())
                     for p, q in zip(resumed[0][1], resumed[1][1]) for k in p)
    resume_loss_err = max(abs(a - b) for a, b in zip(resumed[0][0], resumed[1][0]))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(it)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    ms_per_update = epoch_s * 1e3 / updates

    ok = (losses.shape == (updates,) and bool(np.isfinite(losses).all()) and within
          and all(f["caught"] for f in faults.values()) and loss_fall > 0.0
          and launches == expected
          and restored_counts["cuda"] == restored_counts["cpu"] == restored_counts["written"]
          and acc_err <= EVAL_ACC_ATOL[dtype] and cpu_restore_err == 0.0
          and resume_err == 0.0 and resume_loss_err == 0.0)
    emit("train_recipe", dtype=dtype, batches=[list(x) for x in shapes], updates=updates,
         losses=losses.tolist(), cpu_losses=cpu_losses.tolist(), cpu_loss_fall=loss_fall,
         readings_vs_cpu=readings, limits=lim, faults_vs_cpu=faults,
         kernel_launches=launches, expected_launches=expected,
         evaluate_accuracy=acc, evaluate_accuracy_atol=EVAL_ACC_ATOL[dtype],
         evaluate_examples=evals["cuda"].examples,
         checkpoint_iteration_epoch=restored_counts,
         checkpoint_cpu_restore_max_abs_err=cpu_restore_err,
         resume_max_param_abs_err=resume_err, resume_max_loss_abs_err=resume_loss_err,
         compared_epoch_s=gpu_s, cpu_epoch_s=cpu_s, timed_epoch_s=epoch_s,
         ms_per_update=ms_per_update, real_chars_per_s=real_chars / epoch_s,
         padded_chars_per_s=padded_chars / epoch_s, ok=ok, gpu=card)
    if not ok:
        raise AssertionError(f"training recipe {dtype} failed its checks")
    return launches, ms_per_update, net, it


# ---- the per-step cell (rows 1-2): the char-RNN above on the route
# lstm_variant="fusedcell", a loop of one cell launch per layer and step
CELL_KERNELS = {
    "lstm_cell_fwd": (CSRC + "lstm_cell.cu", PALLAS + "168"),
    "lstm_cell_bwd": (CSRC + "lstm_cell.cu", PALLAS + "202"),
}
CELL_ACTS = ("tanh", "sigmoid", "hardsigmoid", "relu", "identity")
# H=130: rows of h and RW start only 8- (f32) or 4-byte (bf16) aligned, so
# the products copy 4 bytes at a time; H=129 in bf16: only 2-byte aligned,
# so the forward step copies one element at a time
CELL_CASES = [(B, H) for B in (1, SLOTS, BATCH, 67) for H in (129, 130, HIDDEN)]
CELL_FWD = ("h", "c", "a", "f", "o", "i", "cact")
CELL_BWD = ("dzx", "dh_prev", "dc_prev", "dRW", "dpF", "dpI", "dpO")
# rows 1-2 against their plain versions on the same CUDA tensors, every
# output by max |err| / max |ref| and mean |err| / mean |ref|. f32 differs
# only in the order of the products' sums (and an FMA the compiler may
# contract in the forward's gate sums): about 1e-7 of the largest value. In
# bf16 the elementwise math rounds where the plain version rounds, so a
# reading comes only from a product that a sum in another order rounds to
# the neighbouring bf16, at most 2^-8 of an element, in few elements: the
# sequence kernels' limits for a short sequence (BF16_TRAIN_REL["tail"]).
# The phase computes two wrong plain versions, the forward with o reading
# c_prev instead of c through pO and the backward without df*pF in dc_prev,
# the backward with each wrong dRW product of DRW_FAULTS, and the forward
# with each wrong product of PRODUCT_FAULTS, and fails unless every one
# reads above these limits.
CELL_REL = {"float32": {"max": 1e-5, "mean": 1e-5}, "bfloat16": BF16_TRAIN_REL["tail"]}
CELL_FAULTS = ("o_sees_c_prev", "dc_prev_without_df_pF")


def bound_cell(B: int, H: int, dtype: str, backward: bool):
    """Row 1: zx [B, 4H], h_prev, c_prev, RW and the peepholes read, seven
    [B, H] outputs written, the product's 2*B*H*4H operations. Row 2: the
    residuals a, f, o, i, act(c), c_prev, c, h_prev, dh and dc [B, H], RW and
    the peepholes read; dzx [B, 4H], dh_prev, dc_prev, dRW [H, 4H] and the
    three peephole grads written; two products of 2*B*4H*H operations.
    Products at the tensor cores' peak (f32 at the 3xTF32 rate)."""
    item = 4 if dtype == "float32" else 2
    if backward:
        elems = 10 * B * H + 2 * (H * 4 * H + 3 * H) + B * 4 * H + 2 * B * H
        return roofline(elems * item, 2 * (2.0 * B * 4 * H * H), dtype, tc_rate(dtype))
    elems = B * 4 * H + 2 * B * H + H * 4 * H + 3 * H + 7 * B * H
    return roofline(elems * item, 2.0 * B * H * 4 * H, dtype, tc_rate(dtype))


def cell_inputs(torch, B, H, dtype, seed):
    """One step's (zx, h_prev, c_prev, RW, pF, pI, pO) on the card, scaled as
    seq_inputs scales them (non-zero peepholes), and upstream (dh, dc)."""
    import numpy as np

    args = seq_inputs(torch, 1, B, H, dtype, False, seed)
    args[0] = args[0][0].contiguous()
    rng = np.random.default_rng(seed + 1)
    up = [torch.as_tensor(rng.normal(0.0, 0.1, (B, H)), dtype=getattr(torch, dtype),
                          device=DEVICE) for _ in range(2)]
    return args, up


def cell_residuals(args, fwd):
    """The backward's residuals from a forward's (h, c, a, f, o, i, act(c))."""
    zx, h_prev, c_prev, RW, pF, pI, pO = args
    return tuple(fwd[2:7]) + (c_prev, fwd[1], h_prev, RW, pF, pI, pO)


def cell_wrong(lc, fault, args, res, up, act="tanh", gate="sigmoid"):
    """A wrong plain version of row 1 (o_sees_c_prev) or row 2
    (dc_prev_without_df_pF, or a wrong dRW product of DRW_FAULTS), for the
    limits to catch."""
    import torch

    if fault in DRW_FAULTS["float32"]:
        dtype = str(res[0].dtype).removeprefix("torch.")
        return lc.lstm_cell_backward_reference(*res, *up, act, gate,
                                               drw=drw_fault(fault, dtype))

    if fault == "o_sees_c_prev":
        zx, h_prev, c_prev, RW, pF, pI, pO = args
        H = c_prev.shape[-1]
        A, G = lc.ACT[act], lc.ACT[gate]
        z = zx + torch.matmul(h_prev.float(), RW.float()).to(zx.dtype)
        a = A(z[:, :H])
        f = G(z[:, H:2 * H] + c_prev * pF)
        i = G(z[:, 3 * H:] + c_prev * pI)
        c = f * c_prev + i * a
        o = G(z[:, 2 * H:3 * H] + c_prev * pO)
        return (o * A(c), c, a, f, o, i, A(c))
    a, f, o, i, cact, c_prev, c, h_prev, RW, pF, pI, pO = res
    grads = list(lc.lstm_cell_backward_reference(*res, *up, act, gate))
    H = c_prev.shape[-1]
    dc_tot = up[1] + up[0] * o * lc.DACT[act](cact) + grads[0][:, 2 * H:3 * H] * pO
    grads[2] = dc_tot * f + grads[0][:, 3 * H:] * pI
    return tuple(grads)


def rel_readings(got, want, names) -> dict:
    """Each output's max |err| / max |ref| and mean |err| / mean |ref| (0/0
    reads 0), and its max abs error."""
    out = {}
    for n, g, w in zip(names, got, want):
        err, ref = (g.float() - w.float()).abs(), w.float().abs()
        mx, mn = float(ref.max()), float(ref.mean())
        out[n] = {"max_rel": float(err.max()) / mx if mx else float(err.max()),
                  "mean_rel": float(err.mean()) / mn if mn else float(err.mean()),
                  "max_abs": float(err.max())}
    return out


def within(readings: dict, lim: dict) -> bool:
    return all(r["max_rel"] <= lim["max"] and r["mean_rel"] <= lim["mean"]
               for r in readings.values())  # NaN fails too


def phase_kernels_cell(torch, lc):
    """Rows 1-2 against their plain versions on the same CUDA tensors, f32 and
    bf16, at every (B, H) of CELL_CASES and every activation pair; one line
    per dtype and shape with the worst reading of each output over the
    pairs. Then the two wrong plain versions at the main shape, which the
    limits must catch. Returns the max abs error of each kernel at the main
    shape in f32 (the kernels line)."""
    errs = {}
    for dtype in ("float32", "bfloat16"):
        lim = CELL_REL[dtype]
        for B, H in CELL_CASES:
            worst: dict = {}
            args, up = cell_inputs(torch, B, H, dtype, SEED + B + H)
            for act in CELL_ACTS:
                for gate in CELL_ACTS:
                    got = lc.lstm_cell_forward(*args, act, gate)
                    want = lc.lstm_cell_forward_reference(*args, act, gate)
                    res = cell_residuals(args, want)
                    grads = lc.lstm_cell_backward(*res, *up, act, gate)
                    ref = lc.lstm_cell_backward_reference(*res, *up, act, gate)
                    torch.cuda.synchronize()
                    r = rel_readings(list(got) + list(grads), list(want) + list(ref),
                                     CELL_FWD + CELL_BWD)
                    for n, v in r.items():
                        w = worst.setdefault(n, dict.fromkeys(v, 0.0))
                        for k in v:
                            w[k] = max(w[k], v[k]) if v[k] == v[k] else v[k]  # keep NaN
            ok = within(worst, lim)
            emit("kernel_vs_plain", kernel="lstm_cell_fwd+lstm_cell_bwd", dtype=dtype, B=B,
                 H=H, activation_pairs=len(CELL_ACTS) ** 2, worst_by_output=worst,
                 limit_max_rel=lim["max"], limit_mean_rel=lim["mean"], ok=ok)
            if not ok:
                raise AssertionError(f"lstm_cell {dtype} B={B} H={H}: outside {lim}: {worst}")
            if (B, H) == (BATCH, HIDDEN) and dtype == "float32":
                errs["lstm_cell_fwd"] = max(worst[n]["max_abs"] for n in CELL_FWD)
                errs["lstm_cell_bwd"] = max(worst[n]["max_abs"] for n in CELL_BWD)
        args, up = cell_inputs(torch, BATCH, HIDDEN, dtype, SEED)
        got = lc.lstm_cell_forward(*args)
        want = lc.lstm_cell_forward_reference(*args)
        res = cell_residuals(args, want)
        grads = lc.lstm_cell_backward(*res, *up)
        torch.cuda.synchronize()
        faults = {}
        for fault in CELL_FAULTS + DRW_FAULTS[dtype]:
            wrong = cell_wrong(lc, fault, args, res, up)
            kern, names = (got, CELL_FWD) if fault == "o_sees_c_prev" else (grads, CELL_BWD)
            r = rel_readings(kern, wrong, names)
            bad = {n: v for n, v in r.items() if not within({n: v}, lim)}
            faults[fault] = {"outputs_outside_the_limits": bad, "caught": bool(bad)}
        ok = all(f["caught"] for f in faults.values())
        emit("kernel_vs_wrong_plain", kernel="lstm_cell_fwd+lstm_cell_bwd", dtype=dtype,
             B=BATCH, H=HIDDEN, faults=faults, limit_max_rel=lim["max"],
             limit_mean_rel=lim["mean"], ok=ok)
        if not ok:
            raise AssertionError(f"lstm_cell {dtype}: a wrong plain version passed {faults}")

        def cell_limit(wrong, ref, lim=lim):
            r = rel_readings(wrong, ref, CELL_FWD)
            return r, within(r, lim)

        fwd_faults_caught(
            "lstm_cell_fwd", dtype,
            lambda product: lc.lstm_cell_forward_reference(*args, product=product), want,
            cell_limit, dict(B=BATCH, H=HIDDEN, limit_max_rel=lim["max"],
                             limit_mean_rel=lim["mean"]))
    return errs


def cell_launches(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def phase_serve_cell(torch, confs, host_params, x, seq_net, card):
    """The fusedcell net served at B=64, T=256: output/predict in f32 and
    bf16 against the same net on the CPU, in f32 also against the seqfused
    net on the card (``seq_net``), with exactly STEPS * LAYERS row-1
    launches per call and no other kernel; then DecodeServer with 8 slots
    against each session alone, one row-1 launch per layer and tick. Counts
    from 0. Returns the main path's launches."""
    import numpy as np

    from deeplearning4j_tpu_torch import DecodeServer, MultiLayerNetwork, load_jax_params, ops

    nets = {dt: load_jax_params(MultiLayerNetwork(c, lstm_variant="fusedcell"), host_params)
            for dt, c in confs.items()}
    torch.cuda.synchronize()
    ops.reset_counters()
    served = {}
    for dt, net in nets.items():
        before = ops.counters()
        t0 = time.perf_counter()
        probs = net.output(x)
        output_ms = (time.perf_counter() - t0) * 1e3
        cls = net.predict(x)
        torch.cuda.synchronize()
        served[dt] = (probs, cls, cell_launches(before, ops.counters()), output_ms)
    server = DecodeServer(nets["float32"], capacity=SLOTS, max_delay_ms=2.0)
    before = ops.counters()
    trajectories, decode_s = decode_sessions(server)
    ticks = server.ticks
    server.stop()
    torch.cuda.synchronize()
    decode_launches = cell_launches(before, ops.counters())
    launches = ops.counters()

    seq_probs = seq_net.output(x)
    per_call = {"lstm_cell_fwd": STEPS * LAYERS}
    for dt, (probs, cls, rose, output_ms) in served.items():
        cpu = load_jax_params(MultiLayerNetwork(confs[dt], device="cpu",
                                                lstm_variant="fusedcell"), host_params)
        ref = cpu.output(x)
        err = float(np.abs(probs - ref).max())
        seq_err = float(np.abs(probs - seq_probs).max()) if dt == "float32" else None
        expected = {"lstm_cell_fwd": 2 * STEPS * LAYERS}  # output and predict
        ok = (probs.shape == (BATCH, STEPS, VOCAB) and bool(np.isfinite(probs).all())
              and float(np.abs(probs.sum(-1) - 1.0).max()) < 1e-2
              and cls.shape == (BATCH, STEPS) and rose == expected
              and err <= SERVE_ATOL[dt] and (seq_err is None or seq_err <= SERVE_ATOL[dt]))
        emit("serve_cell", dtype=dt, shape=list(probs.shape), kernel_launches=rose,
             expected_launches=expected, launches_per_call=per_call,
             max_abs_err_vs_cpu=err, max_abs_err_vs_seqfused_on_card=seq_err,
             atol=SERVE_ATOL[dt], argmax_agree_vs_cpu=float((cls == ref.argmax(-1)).mean()),
             first_output_ms=output_ms, ok=ok, gpu=card)
        if not ok:
            raise AssertionError(f"serving the fusedcell net {dt} failed its checks")

    alone_err, same_tokens = decode_vs_alone(nets["float32"], trajectories)
    expected = {"lstm_cell_fwd": ticks * LAYERS}
    ok = same_tokens and alone_err <= DECODE_ATOL and decode_launches == expected
    emit("decode_server_cell", sessions=SLOTS, chars_each=DECODE_CHARS, ticks=ticks,
         seconds=decode_s, tokens_per_s=SLOTS * DECODE_CHARS / decode_s,
         kernel_launches=decode_launches, expected_launches=expected,
         same_tokens_as_alone=same_tokens, max_abs_err_vs_alone=alone_err,
         atol=DECODE_ATOL, ok=ok, gpu=card)
    if not ok:
        raise AssertionError("fusedcell decode sessions differ from running alone")
    return launches


def cell_train_run(torch, conf, dev, route, host_params, data, timed=False):
    """``fit`` over ``data`` (a list of (x, y) batches or an iterator) from the
    seed params on ``dev`` and ``route``. Returns ((net, losses, params),
    the card's launches counted from 0, and, when ``timed``, ms per update of
    one more pass over the same data)."""
    import numpy as np

    from deeplearning4j_tpu_torch import MultiLayerNetwork, load_jax_params, ops, params_to_numpy

    net = load_jax_params(MultiLayerNetwork(conf, device=dev, lstm_variant=route),
                          host_params)
    rec = LossRecorder()
    net.set_listeners(rec)
    launches = None
    if dev == "cuda":
        torch.cuda.synchronize()
        ops.reset_counters()
    for batch in (data if isinstance(data, list) else [data]):
        net.fit(batch)
    if dev == "cuda":
        torch.cuda.synchronize()
        launches = ops.counters()
    net.set_listeners()
    run = (net, np.array([float(l) for l in rec.losses]), params_to_numpy(net))
    ms = None
    if timed:
        t0 = time.perf_counter()
        for batch in (data if isinstance(data, list) else [data]):
            net.fit(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(run[1])
    return run, launches, ms


def phase_train_cell(torch, dtype, host_params, card):
    """The fusedcell char-RNN trained at full width on the card and on the CPU
    from the seed params: SGD ``fit`` standard (1 batch, T=256) and TBPTT(50)
    (1 batch, 6 updates), held by phase_train's limits (TRAIN_LOSS_RTOL,
    TRAIN_PARAM_ATOL, TRAIN_STEP_RTOL), and the recipe (Adam over the
    bucketed padded batches, one epoch of 9 updates), held by
    RECIPE_LIMITS; in f32 each also against the card's seqfused run by the
    same limits. Exact launches of rows 1-2 per update (one per layer and
    step), and none of the sequence kernels. Then one more timed epoch of
    the recipe on each card route. Returns (the main path's launches, ms per
    recipe update by route, the standard SGD net and its batch)."""
    import numpy as np

    from deeplearning4j_tpu_torch import BucketingSequenceIterator, char_rnn

    sgd_limits = {"loss_rel": TRAIN_LOSS_RTOL[dtype], "param_abs": TRAIN_PARAM_ATOL[dtype],
                  "change_rel": TRAIN_STEP_RTOL[dtype]}
    batch = char_batches(1, SEED + 3)
    it = BucketingSequenceIterator(recipe_sequences(), batch=BATCH, boundaries=RECIPE_BUCKETS)
    segments = {"standard": [STEPS], "tbptt": [TBPTT] * (STEPS // TBPTT) + [TAIL],
                "recipe": [min(TBPTT, t - t0) for t in RECIPE_BUCKETS
                           for t0 in range(0, t, TBPTT)]}
    total: dict = {}
    recipe_ms, sgd_net = {}, None
    for what in ("standard", "tbptt", "recipe"):
        if what == "recipe":
            conf = char_rnn(VOCAB, HIDDEN, LAYERS, dtype=dtype)
            data, readings, limits = it, recipe_readings, RECIPE_LIMITS[dtype]
        else:
            conf = char_rnn(VOCAB, HIDDEN, LAYERS, tbptt_length=TBPTT, dtype=dtype)
            conf.updater = {"updater": "sgd", "learning_rate": LR}
            conf.backprop_type = what
            data, readings, limits = batch, sgd_readings, sgd_limits
        timed = what == "recipe"
        run, launches, ms = cell_train_run(torch, conf, "cuda", "fusedcell", host_params,
                                           data, timed)
        t0 = time.perf_counter()
        cpu, _, _ = cell_train_run(torch, conf, "cpu", "fusedcell", host_params, data)
        cpu_s = time.perf_counter() - t0
        vs = {"cpu_fusedcell": readings(run, cpu, host_params)}
        seq_ms = None
        if dtype == "float32":
            seq, _, seq_ms = cell_train_run(torch, conf, "cuda", "seqfused", host_params, data,
                                            timed)
            vs["card_seqfused"] = readings(run, seq, host_params)
        updates = len(segments[what])
        steps = sum(segments[what])
        expected = dict.fromkeys(launches, 0)
        expected.update({"lstm_cell_fwd": LAYERS * steps, "lstm_cell_bwd": LAYERS * steps,
                         "drw_product": LAYERS * steps,
                         "softmax_xent_fwd": updates, "softmax_xent_bwd": updates})
        if what == "recipe":
            expected["adam_update"] = updates * adam_launches(run[0])
        losses = run[1]
        ok = (losses.shape == (updates,) and bool(np.isfinite(losses).all())
              and all(within_limits(r, limits) for r in vs.values())
              and launches == expected)
        emit("train_cell", what=what, dtype=dtype, updates=updates, steps_per_layer=steps,
             losses=losses.tolist(), cpu_losses=cpu[1].tolist(), readings=vs, limits=limits,
             kernel_launches={k: v for k, v in launches.items() if v},
             expected_launches={k: v for k, v in expected.items() if v},
             launches_per_update={k: v / updates for k, v in launches.items() if v},
             cpu_seconds=cpu_s, ms_per_update_fusedcell=ms, ms_per_update_seqfused=seq_ms,
             ok=ok, gpu=card)
        if not ok:
            raise AssertionError(f"training the fusedcell net ({what}, {dtype}) failed")
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        if what == "recipe":
            recipe_ms = {"fusedcell": ms, "seqfused": seq_ms}
        if what == "standard":
            sgd_net = run[0]
    return total, recipe_ms, sgd_net, batch[0]


def time_cell(torch, lc, times, card):
    """Rows 1-2 at the main shape (B=64; row 1 also at the decode tick's B=8)
    beside their plain versions and bounds (no single PyTorch call computes
    the peephole cell: library none), and one step of each beside row 5's
    decode launch and row 7's time per step."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        for B, rows in ((BATCH, ("lstm_cell_fwd", "lstm_cell_bwd")), (SLOTS, ("lstm_cell_fwd",))):
            args, up = cell_inputs(torch, B, HIDDEN, dtype, SEED)
            res = cell_residuals(args, lc.lstm_cell_forward_reference(*args))
            for name in rows:
                if name == "lstm_cell_fwd":
                    kern = lambda: lc.lstm_cell_forward(*args)  # noqa: E731
                    plain = lambda: lc.lstm_cell_forward_reference(*args)  # noqa: E731
                else:
                    kern = lambda: lc.lstm_cell_backward(*res, *up)  # noqa: E731
                    plain = lambda: lc.lstm_cell_backward_reference(*res, *up)  # noqa: E731
                b_ms, b_by = bound_cell(B, HIDDEN, dtype, name == "lstm_cell_bwd")
                out[(name, dtype, B)] = time_pair(torch, name, kern, plain, None, b_ms, b_by,
                                                  card, dtype=dtype, B=B, H=HIDDEN)
        emit("cell_vs_sequence", dtype=dtype, gpu=card,
             cell_fwd_ms_b8=out[("lstm_cell_fwd", dtype, SLOTS)]["ms"],
             seq_lean_masked_ms_t1_b8=times[("lstm_seq_lean_masked", dtype)]["ms"],
             cell_fwd_ms_b64=out[("lstm_cell_fwd", dtype, BATCH)]["ms"],
             seq_train_fwd_ms_per_step=times[("lstm_seq_train_fwd", dtype)]["ms"] / STEPS,
             cell_bwd_ms_b64=out[("lstm_cell_bwd", dtype, BATCH)]["ms"],
             seq_bwd_ms_per_step=times[("lstm_seq_bwd", dtype)]["ms"] / STEPS)
    return out


# ---- the causal self-attention slice: the transformer block of
# examples/long_context.py without its MoE layer, two blocks deep, over the
# char-RNN's vocabulary, at bench.py:510's attention shape (B=4, 8 heads,
# T=4096, head dim 64, causal), so n_out 512; Adam at lr 3e-3 (the example's)
ATTN_B, ATTN_HEADS, ATTN_T, ATTN_D = 4, 8, 4096, 64
ATTN_N = ATTN_HEADS * ATTN_D
ATTN_LR = 3e-3
ATTN_BUCKETS = (2048, 4096)  # training text: 4 sequences of 1024-2048 and 4 of 2049-4096
ATTN_CPU_BUCKETS = (256, 512)  # card against CPU: the CPU's plain attention is O(T^2)
FLASH = "deeplearning4j_tpu/ops/flash_attention.py:"
ATTN_KERNELS = {
    "flash_attn_fwd": (CSRC + "flash_attn.cu", FLASH + "187"),
    "flash_attn_bwd_dq": (CSRC + "flash_attn_bwd.cu", FLASH + "217"),
    "flash_attn_bwd_dkv": (CSRC + "flash_attn_bwd.cu", FLASH + "233"),
}
# rows 13-15 against their plain versions on the same CUDA tensors: each
# output's max |err| over the larger of its max |ref| and 1 (the inputs'
# scale: at T=1, dq and dk are 0 up to the rounding of dp - delta). f32
# differs in the order of the sums and, in rows 13 and 15, by the 3xTF32
# products (about 2^-21 of each product); bf16 rounds out, dq, dk, dv once,
# so a sum in another order can land on the neighbouring bf16, at most 2^-7
# of the largest value, and rows 13 and 15 round p and ds to bf16 (2^-9 of
# each) before their products. The phase computes three wrong plain
# versions (the backward with delta left out, the forward with the key mask
# ignored, causal masking off by one on the diagonal) and fails unless each
# reads above these limits. The cases cover every instantiated head dim and
# T on both sides of the 64-row tiles of rows 13 and 15.
ATTN_REL = {"float32": 1e-4, "bfloat16": 1e-2}
ATTN_CASES = [(D, T) for D in (4, 8, 16, 32, 64, 128) for T in (1, 63, 65, 200, 4096)]
# training on the card against the same training on the CPU at T <= 512, by
# the recipe's four readings (recipe_readings), lr = 3e-3. Limits between
# what the correct kernels read on the H100 (f32: losses 7.6e-7, change
# 1.6e-4, largest difference 5.5e-4, 1 element over lr/10; bf16: 3.8e-4,
# 0.040, 0.0122, 11,705 of 1,510,496) and the same training on the card
# with delta left out of the backward kernels, run in the same phase, which
# must fail them. bf16's largest difference is near the most Adam allows (2
# lr for each of 4 updates, 0.024), so the other three readings carry it.
ATTN_TRAIN_LIMITS = {
    "float32": {"loss_rel": 2e-5, "change_rel": 2e-3, "max_param_abs": 5e-3,
                "elements_over_lr_tenth": 100},
    "bfloat16": {"loss_rel": 1e-2, "change_rel": 0.2, "max_param_abs": 0.02,
                 "elements_over_lr_tenth": 100000},
}


def attention_conf(dtype):
    from deeplearning4j_tpu_torch import (InputType, LayerNormLayer, MultiLayerConfiguration,
                                          RnnOutputLayer, SelfAttentionLayer)

    def attn():
        return SelfAttentionLayer(n_out=ATTN_N, n_heads=ATTN_HEADS, causal=True,
                                  attention_impl="flash")

    return MultiLayerConfiguration(
        layers=[attn(), LayerNormLayer(), attn(), LayerNormLayer(),
                RnnOutputLayer(n_out=VOCAB, activation="softmax", loss="mcxent")],
        input_type=InputType.recurrent(VOCAB),
        updater={"updater": "adam", "learning_rate": ATTN_LR}, seed=SEED, dtype=dtype)


def attention_params(seed):
    """Random weights of the attention net from a numpy seed, one dict of
    arrays per layer in the JAX package's layout: xavier-normal projections,
    zero biases, LayerNorm's gamma 1 and beta 0."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def w(n_in, n_out):
        return rng.normal(0.0, (2.0 / (n_in + n_out)) ** 0.5, (n_in, n_out))

    params = []
    n_in = VOCAB
    for _ in range(2):
        params.append({"Wq": w(n_in, ATTN_N), "Wk": w(n_in, ATTN_N), "Wv": w(n_in, ATTN_N),
                       "Wo": w(ATTN_N, ATTN_N), "bo": np.zeros(ATTN_N)})
        params.append({"gamma": np.ones(ATTN_N), "beta": np.zeros(ATTN_N)})
        n_in = ATTN_N
    params.append({"W": w(ATTN_N, VOCAB), "b": np.zeros(VOCAB)})
    return params


def attn_mask(torch, B, T):
    """A [B, T] key mask with row 0 all zeros, row 1 leading zeros, row 2 an
    interior gap and row 3 trailing zeros (the rest all ones)."""
    import numpy as np

    m = np.ones((B, T), np.float32)
    m[0] = 0.0
    m[1, :max(1, T // 4)] = 0.0
    m[2, T // 3:max(T // 3 + 1, T // 2)] = 0.0
    m[3, max(1, 3 * T // 4):] = 0.0
    return torch.as_tensor(m, device=DEVICE)


def attn_inputs(torch, B, H, T, D, dtype, seed):
    """q, k, v and an upstream gradient [B, H, T, D], unit normals from a
    numpy seed, on the card."""
    import numpy as np

    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    return [torch.as_tensor(rng.normal(0.0, 1.0, (B, H, T, D)), dtype=dt, device=DEVICE)
            for _ in range(4)]


def attn_readings(got, want) -> dict:
    """Per output: max |err| over the larger of max |ref| and 1."""
    return {n: float((g.float() - w.float()).abs().max())
            / max(float(w.float().abs().max()), 1.0) for n, g, w in zip(
                ("out", "lse", "dq", "dk", "dv"), got, want)}


def phase_kernels_attention(torch, fa):
    """Rows 13-15 against their plain versions on the same CUDA tensors: f32
    and bf16, causal and not, ``ATTN_CASES`` at B=4, H=2 with ``attn_mask``,
    and the main shape (B=4, H=8, T=4096, D=64, causal) with and without it.
    Then the wrong plain versions, which the limits must catch. Returns the
    max abs error of each kernel (f32, main shape)."""
    errs, worst, n_cases = {}, {}, 0
    for dtype in ("float32", "bfloat16"):
        lim = ATTN_REL[dtype]
        worst[dtype] = {}
        cases = [(2, D, T, c, True) for D, T in ATTN_CASES for c in (False, True)]
        cases += [(ATTN_HEADS, ATTN_D, ATTN_T, True, m) for m in (False, True)]
        for H, D, T, causal, masked in cases:
            q, k, v, g = attn_inputs(torch, ATTN_B, H, T, D, dtype, SEED + T + D)
            mask = attn_mask(torch, ATTN_B, T) if masked else None
            out, lse = fa.flash_attention_forward(q, k, v, mask, causal)
            dq, delta = fa.flash_attention_dq(q, k, v, mask, out, lse, g, causal)
            dk, dv = fa.flash_attention_dkv(q, k, v, mask, lse, delta, g, causal)
            torch.cuda.synchronize()
            r_out, r_lse = fa.flash_attention_reference(q, k, v, mask, causal)
            want = (r_out, r_lse) + fa.flash_attention_backward_reference(
                q, k, v, mask, r_out, r_lse, g, causal)
            got = (out, lse, dq, dk, dv)
            e = attn_readings(got, want)
            n_cases += 1
            for n, r in e.items():
                worst[dtype][n] = max(worst[dtype].get(n, 0.0), r)
            finite = all(bool(torch.isfinite(t.float()).all()) for t in got)
            check("flash_attn", dtype, e, dict.fromkeys(e, lim), B=ATTN_B, H=H, T=T, D=D,
                  causal=causal, masked=masked, finite=finite,
                  relative_to_max_of_largest_and_1=True)
            if not finite:
                raise AssertionError(f"flash_attn {dtype} H={H} T={T} D={D}: not finite")
            if (H, T) == (ATTN_HEADS, ATTN_T) and dtype == "float32":
                for name, outs in (("flash_attn_fwd", (0, 1)), ("flash_attn_bwd_dq", (2,)),
                                   ("flash_attn_bwd_dkv", (3, 4))):
                    errs[(name, dtype, masked)] = max(
                        float((got[i].float() - want[i].float()).abs().max()) for i in outs)
        # wrong plain versions on a masked causal case: what a kernel that
        # left delta out, ignored the key mask, or admitted key i+1 to row i
        # would read
        q, k, v, g = attn_inputs(torch, ATTN_B, 2, 200, ATTN_D, dtype, SEED)
        mask = attn_mask(torch, ATTN_B, 200)
        r_out, r_lse = fa.flash_attention_reference(q, k, v, mask, True)
        right = fa.flash_attention_backward_reference(q, k, v, mask, r_out, r_lse, g, True)
        no_delta = fa.flash_attention_backward_reference(
            q, k, v, mask, torch.zeros_like(r_out), r_lse, g, True)
        no_mask = fa.flash_attention_reference(q, k, v, None, True)
        off_by_one = causal_off_by_one(torch, fa, q, k, v, mask, g)
        wrong = {"bwd_without_delta": attn_readings((r_out, r_lse) + no_delta,
                                                    (r_out, r_lse) + right),
                 "fwd_mask_ignored": attn_readings(no_mask + right, (r_out, r_lse) + right),
                 "causal_off_by_one": attn_readings(off_by_one, (r_out, r_lse) + right)}
        caught = {"bwd_without_delta": min(wrong["bwd_without_delta"][n] for n in ("dq", "dk")),
                  "fwd_mask_ignored": min(wrong["fwd_mask_ignored"][n] for n in ("out", "lse")),
                  "causal_off_by_one": min(wrong["causal_off_by_one"].values())}
        ok = all(v > lim for v in caught.values())
        emit("kernel_limits", kernel="flash_attn", dtype=dtype, limit=lim, wrong_readings=wrong,
             smallest_reading_of_each_wrong_version=caught, caught=ok)
        if not ok:
            raise AssertionError(f"flash_attn {dtype}: the limit {lim} does not catch {caught}")
    emit("kernels_attention", cases=n_cases, worst_reading_by_dtype=worst, limits=ATTN_REL,
         wrong_versions_caught=True, ok=True)
    return errs


def causal_off_by_one(torch, fa, q, k, v, mask, g):
    """(out, lse, dq, dk, dv) of the plain versions under causal masking
    that admits key i+1 to row i (the diagonal one key too far)."""
    right_valid = fa._valid

    def shifted(key_mask, T, causal, device):
        valid = torch.tril(torch.ones((1, 1, T, T), dtype=torch.bool, device=device),
                           diagonal=1)
        if key_mask is not None:
            valid = valid & (key_mask > 0)[:, None, None, :]
        return valid

    fa._valid = shifted
    try:
        out, lse = fa.flash_attention_reference(q, k, v, mask, True)
        return (out, lse) + fa.flash_attention_backward_reference(q, k, v, mask, out, lse, g,
                                                                   True)
    finally:
        fa._valid = right_valid


def bound_attention(kernel: str, dtype: str, shape, causal=True):
    """Least time of rows 13-15 on attention of [B, H, T, D] inputs without a
    key mask: each [B, H, T, D] input read once and output written once, the
    [B, H, T] f32 row vectors too; 2*D operations per (row, key) pair for
    each product, over T(T+1)/2 pairs a head under causal masking (two
    products for row 13: q k^T and p v; three for row 14: s, dp, ds k; four
    for row 15: s, p^T dO, dp, ds^T q), in bf16 at the bf16 tensor-core
    peak, in f32 at the f32-accurate tensor-core rate (3xTF32,
    ``F32_TC_OPS_PER_S``)."""
    B, H, T, D = shape
    item = 4 if dtype == "float32" else 2
    tensors, rows, products = {"flash_attn_fwd": (4, 1, 2), "flash_attn_bwd_dq": (6, 2, 3),
                               "flash_attn_bwd_dkv": (6, 2, 4)}[kernel]
    pairs = B * H * (T * (T + 1) // 2 if causal else T * T)
    return roofline(tensors * B * H * T * D * item + rows * B * H * T * 4,
                    products * 2.0 * D * pairs, dtype, tc_rate(dtype))


def attention_text(n_short, n_long, lo, mid, hi, seed):
    """Next-char (features [L, VOCAB], labels [L, VOCAB]) pairs of a seeded
    sentence repeated: ``n_short`` lengths in lo..mid and ``n_long`` in
    mid+1..hi drawn from the seed, shuffled."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sentence = rng.integers(0, VOCAB, SENTENCE)
    lengths = np.concatenate([rng.integers(lo, mid + 1, n_short),
                              rng.integers(mid + 1, hi + 1, n_long)])
    rng.shuffle(lengths)
    out = []
    for n in lengths:
        seq = sentence[(rng.integers(0, SENTENCE) + np.arange(n + 1)) % SENTENCE]
        out.append((one_hot(seq[:-1], VOCAB), one_hot(seq[1:], VOCAB)))
    return out


def phase_serve_attention(torch, card):
    """``output`` and ``predict`` of the attention net at full width, B=4,
    T=4096, and ``output`` of padded requests (trailing zeros in the
    features mask): shape, rows that sum to 1, exactly 2 row-13 launches per
    call and no other kernel, the real steps of the padded requests as in the
    full ones (causal attention never sees a later key), and the card
    against the CPU at T=512. Returns the launch counts."""
    import numpy as np

    from deeplearning4j_tpu_torch import MultiLayerNetwork, load_jax_params, ops

    rng = np.random.default_rng(SEED + 3)
    x = one_hot(rng.integers(0, VOCAB, (ATTN_B, ATTN_T)), VOCAB)
    lengths = np.array([ATTN_T, 3000, 2048, 777])
    fmask = (np.arange(ATTN_T)[None, :] < lengths[:, None]).astype(np.float32)
    host = attention_params(SEED)
    launches = {}
    for dtype in ("float32", "bfloat16"):
        conf = attention_conf(dtype)
        net = load_jax_params(MultiLayerNetwork(conf), host)
        per_call = {}
        results = {}
        for call, fn in (("output", lambda: net.output(x)), ("predict", lambda: net.predict(x)),
                         ("output_padded", lambda: net.output(x, features_mask=fmask))):
            torch.cuda.synchronize()
            ops.reset_counters()
            results[call] = fn()
            torch.cuda.synchronize()
            per_call[call] = {k: v for k, v in ops.counters().items() if v}
        probs, cls, padded = results["output"], results["predict"], results["output_padded"]
        for counts in per_call.values():
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
        real = fmask > 0
        padded_err = float(np.abs(padded[real] - probs[real]).max())
        cpu = load_jax_params(MultiLayerNetwork(conf, device="cpu"), host)
        t_cpu = ATTN_CPU_BUCKETS[-1]
        short_mask = (np.arange(t_cpu)[None, :] < np.array([t_cpu, 400, 300, 77])[:, None])
        cpu_err = max(float(np.abs(net.output(x[:, :t_cpu], features_mask=m)
                                   - cpu.output(x[:, :t_cpu], features_mask=m)).max())
                      for m in (None, short_mask.astype(np.float32)))
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            net.output(x)
            runs.append((time.perf_counter() - t0) * 1e3)
        ok = (probs.shape == (ATTN_B, ATTN_T, VOCAB) and bool(np.isfinite(probs).all())
              and bool(np.isfinite(padded).all())
              and float(np.abs(probs.sum(-1) - 1.0).max()) < 1e-2
              and cls.shape == (ATTN_B, ATTN_T) and bool((cls == probs.argmax(-1)).all())
              and all(c == {"flash_attn_fwd": 2} for c in per_call.values())
              and padded_err <= 1e-6 and cpu_err <= SERVE_ATOL[dtype])
        emit("serve_attention", dtype=dtype, B=ATTN_B, T=ATTN_T, n_out=ATTN_N,
             heads=ATTN_HEADS, shape=list(probs.shape), launches_per_call=per_call,
             padded_real_steps_max_abs_diff=padded_err, padded_lengths=lengths.tolist(),
             max_abs_err_vs_cpu_at_T512=cpu_err, atol=SERVE_ATOL[dtype],
             output_ms_runs=runs, output_ms_median=statistics.median(runs), ok=ok, gpu=card)
        if not ok:
            raise AssertionError(f"attention serving {dtype} failed its checks")
    return launches


def phase_train_attention(torch, dtype, card):
    """The attention net's training at full width from the seed params:
    ``fit`` over BucketingSequenceIterator(4, (2048, 4096)) on the card with
    exact launch counts per update; the same training at T <= 512 on the
    card and on the CPU, held by ``recipe_readings`` (losses must fall);
    ``evaluate`` on both; a checkpoint of the full-T net restored on the card
    (continuing exactly as the original) and on the CPU (exactly the same
    params and Adam state); one timed epoch. Returns (launch counts, ms per
    update, the card's net, the iterator)."""
    import os
    import tempfile

    import numpy as np

    from deeplearning4j_tpu_torch import (BucketingSequenceIterator, MultiLayerNetwork,
                                          load_jax_params, ops, params_to_numpy,
                                          restore_model, write_model)

    fa = importlib.import_module("deeplearning4j_tpu_torch.ops.flash_attention")
    conf = attention_conf(dtype)
    host = attention_params(SEED)
    it = BucketingSequenceIterator(attention_text(4, 4, 1024, 2048, 4096, SEED + 4),
                                   batch=ATTN_B, boundaries=ATTN_BUCKETS)
    shapes = [ds.features.shape[:2] for ds in it]
    if sorted(shapes) != [(ATTN_B, b) for b in ATTN_BUCKETS]:
        raise AssertionError(f"attention batches {shapes}")
    updates = len(shapes)
    net = load_jax_params(MultiLayerNetwork(conf), host)
    rec = LossRecorder()
    net.set_listeners(rec)
    torch.cuda.synchronize()
    ops.reset_counters()
    net.fit(it)
    torch.cuda.synchronize()
    launches = ops.counters()
    net.set_listeners()
    losses = np.array([float(l) for l in rec.losses])
    leaves = sum(len(p) for p in net.layer_params)
    expected = dict.fromkeys(launches, 0)
    expected.update({"flash_attn_fwd": 2 * updates, "flash_attn_bwd_dq": 2 * updates,
                     "flash_attn_bwd_dkv": 2 * updates, "softmax_xent_fwd": updates,
                     "softmax_xent_bwd": updates, "adam_update": adam_launches(net) * updates})

    # the card against the CPU at T <= 512, two epochs
    small = BucketingSequenceIterator(attention_text(4, 4, 128, 256, 512, SEED + 5),
                                      batch=ATTN_B, boundaries=ATTN_CPU_BUCKETS)

    def train_small(dev):
        n = load_jax_params(MultiLayerNetwork(conf, device=dev), host)
        r = LossRecorder()
        n.set_listeners(r)
        n.fit(small, epochs=2)
        n.set_listeners()
        return n, np.array([float(l) for l in r.losses]), params_to_numpy(n)

    runs = {dev: train_small(dev) for dev in ("cuda", "cpu")}
    readings = recipe_readings(runs["cuda"], runs["cpu"], host, lr=ATTN_LR)
    lim = ATTN_TRAIN_LIMITS[dtype]
    within = within_limits(readings, lim)
    # the same training on the card with delta left out of the backward
    # kernels (the dq kernel handed out = 0), which the limits must catch
    real_dq = fa.flash_attention_dq
    fa.flash_attention_dq = lambda q, k, v, m, out, *a: real_dq(q, k, v, m,
                                                                torch.zeros_like(out), *a)
    try:
        fault = recipe_readings(train_small("cuda"), runs["cpu"], host, lr=ATTN_LR)
    finally:
        fa.flash_attention_dq = real_dq
    fault["caught"] = not within_limits(fault, lim)
    cpu_losses = runs["cpu"][1]
    loss_fall = float(cpu_losses[:2].mean() - cpu_losses[-2:].mean())
    acc = {dev: runs[dev][0].evaluate(small).accuracy() for dev in runs}
    acc_err = abs(acc["cuda"] - acc["cpu"])

    # checkpoint of the full-T net
    first = next(iter(it))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "attention.zip")
        write_model(net, path)
        back = restore_model(path)
        on_cpu = restore_model(path, device="cpu")
    iterations = {"written": net.iteration, "cuda": back.iteration, "cpu": on_cpu.iteration}
    cpu_restore_err = max(
        max(float(np.abs(p[k] - q[k]).max()) for p, q in
            zip(params_to_numpy(net), params_to_numpy(on_cpu)) for k in p),
        max(float((a.float().cpu() - b.float()).abs().max()) for a, b in
            zip(net.updater_state_leaves(), on_cpu.updater_state_leaves())))
    resumed = []
    for n in (net, back):
        r = LossRecorder()
        n.set_listeners(r)
        n.fit(first)
        n.set_listeners()
        resumed.append(([float(l) for l in r.losses], params_to_numpy(n)))
    resume_err = max(float(np.abs(p[k] - q[k]).max())
                     for p, q in zip(resumed[0][1], resumed[1][1]) for k in p)
    resume_loss_err = max(abs(a - b) for a, b in zip(resumed[0][0], resumed[1][0]))

    epochs_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(it)
        torch.cuda.synchronize()
        epochs_s.append(time.perf_counter() - t0)
    epoch_s = statistics.median(epochs_s)
    real_tokens = sum(len(x) for x, _ in it.sequences)
    padded_tokens = sum(b * t for b, t in shapes)
    ok = (losses.shape == (updates,) and bool(np.isfinite(losses).all())
          and launches == expected and within and fault["caught"] and loss_fall > 0.0
          and acc_err <= EVAL_ACC_ATOL[dtype] and cpu_restore_err == 0.0
          and resume_err == 0.0 and resume_loss_err == 0.0
          and len(set(iterations.values())) == 1)
    emit("train_attention", dtype=dtype, batches=[list(s) for s in shapes], updates=updates,
         losses=losses.tolist(), kernel_launches=launches, expected_launches=expected,
         param_leaves=leaves, compared_at_T512={
             "batches": [list(ds.features.shape[:2]) for ds in small], "updates": 2 * len(
                 list(small)), "cpu_losses": cpu_losses.tolist(),
             "card_losses": runs["cuda"][1].tolist()},
         readings_vs_cpu=readings, limits=lim, fault_bwd_without_delta_vs_cpu=fault,
         cpu_loss_fall=loss_fall,
         evaluate_accuracy=acc, evaluate_accuracy_atol=EVAL_ACC_ATOL[dtype],
         checkpoint_iterations=iterations, checkpoint_cpu_restore_max_abs_err=cpu_restore_err,
         resume_max_param_abs_err=resume_err, resume_max_loss_abs_err=resume_loss_err,
         timed_epoch_s_runs=epochs_s, ms_per_update=epoch_s * 1e3 / updates,
         real_tokens_per_s=real_tokens / epoch_s, padded_tokens_per_s=padded_tokens / epoch_s,
         ok=ok, gpu=card)
    if not ok:
        raise AssertionError(f"attention training {dtype} failed its checks")
    return launches, epoch_s * 1e3 / updates, net, it


def time_attention(torch, fa, card):
    """ms of rows 13-15 at the main shape (B=4, H=8, T=4096, D=64, causal, no
    key mask), f32 and bf16, beside the plain versions, the bounds and
    scaled_dot_product_attention (forward for row 13; forward plus backward,
    more work than either backward kernel, for rows 14-15); then forward plus
    backward tokens/s at bench.py:510's measurement (bf16, loss sum(out^2))."""
    import torch.nn.functional as F

    times = {}
    for dtype in ("float32", "bfloat16"):
        q, k, v, g = attn_inputs(torch, ATTN_B, ATTN_HEADS, ATTN_T, ATTN_D, dtype, SEED)
        out, lse = fa.flash_attention_forward(q, k, v, None, True)
        _, delta = fa.flash_attention_dq(q, k, v, None, out, lse, g, True)
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

        def sdpa_fwd_bwd():
            qg.grad = kg.grad = vg.grad = None
            F.scaled_dot_product_attention(qg, kg, vg, is_causal=True).backward(g)

        cases = (
            ("flash_attn_fwd", lambda: fa.flash_attention_forward(q, k, v, None, True),
             lambda: fa.flash_attention_reference(q, k, v, None, True),
             lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
            ("flash_attn_bwd_dq", lambda: fa.flash_attention_dq(q, k, v, None, out, lse, g, True),
             lambda: fa.flash_attention_dq_reference(q, k, v, None, out, lse, g, True),
             sdpa_fwd_bwd),
            ("flash_attn_bwd_dkv",
             lambda: fa.flash_attention_dkv(q, k, v, None, lse, delta, g, True),
             lambda: fa.flash_attention_dkv_reference(q, k, v, None, lse, delta, g, True),
             sdpa_fwd_bwd),
        )
        for name, kern, plain, lib in cases:
            times[(name, dtype)] = time_pair(
                torch, name, kern, plain, lib, *bound_attention(name, dtype, q.shape), card,
                dtype=dtype, B=ATTN_B, H=ATTN_HEADS, T=ATTN_T, D=ATTN_D, causal=True)

    # forward + backward through the autograd Function, bench.py's loss
    from deeplearning4j_tpu_torch import ops

    q, k, v, _ = attn_inputs(torch, ATTN_B, ATTN_HEADS, ATTN_T, ATTN_D, "bfloat16", SEED + 1)
    qg, kg, vg = (t.mul(0.3).requires_grad_() for t in (q, k, v))

    def step(attn):
        qg.grad = kg.grad = vg.grad = None
        (attn(qg, kg, vg).float() ** 2).sum().backward()

    flash_ms = median_ms(lambda: step(lambda a, b, c: ops.flash_attention(a, b, c, causal=True)))
    sdpa_ms = median_ms(lambda: step(
        lambda a, b, c: F.scaled_dot_product_attention(a, b, c, is_causal=True)))
    emit("time_attention", kernel_ms={f"{n} {d}": t["ms"] for (n, d), t in times.items()},
         bound_ms={f"{n} {d}": t["bound_ms"] for (n, d), t in times.items()},
         train_step_dtype="bfloat16", B=ATTN_B, H=ATTN_HEADS, T=ATTN_T, D=ATTN_D,
         causal=True, step_ms=flash_ms, tokens_per_s=ATTN_B * ATTN_T / (flash_ms / 1e3),
         sdpa_step_ms=sdpa_ms, sdpa_tokens_per_s=ATTN_B * ATTN_T / (sdpa_ms / 1e3),
         note="query positions per second of forward+backward, as bench.py's "
              "flash_attention_train_tokens_per_sec counts them; sdpa is timed only",
         gpu=card)
    return times


# ---- the AlexNet slice: alexnet_conf() at its own widths (224x224x3 images,
# 1000 classes, 62.4M params), B=128 as the repo's CNN bench uses
# (bench.py:180); Nesterov at lr 1e-2 and dropout 0.5 (the conf's). Images
# and labels are synthetic, drawn from the seed: raw pixel values 0-255, as
# an image reader yields them before any normalizer, at which LRN's window
# sums weigh on its output.
ALEX_B, ALEX_CPU_B, ALEX_UPDATES = 128, 8, 3
LRN_K, LRN_N, LRN_ALPHA, LRN_BETA = 2.0, 5, 1e-4, 0.75
LRN_SHAPES = {"lrn1": (ALEX_B, 56, 56, 96), "lrn2": (ALEX_B, 27, 27, 256)}
LRN_KERNELS = {
    "lrn_fwd": (CSRC + "lrn.cu", PALLAS + "292"),
    "lrn_bwd": (CSRC + "lrn.cu", PALLAS + "315"),
}
# rows 3-4 against their plain versions on the same CUDA tensors: each
# output's max |err| over its max |ref|. Both round at the same points and
# take the same powf, so f32 and bf16 read 0 up to a power's last bit,
# which in bf16 can move a value by one step (2^-8 of the largest). The
# phase computes two wrong plain versions, the backward's window not
# reflected (n=4) and dx without its second term, which must read above.
LRN_REL = {"float32": 1e-6, "bfloat16": 2.0 ** -8}
# every plan of ops/lrn.py: one channel, C below a vector, C not a multiple
# of one (vectors cross rows), AlexNet's, and rows wider than a tile
LRN_CASES = [(C, n) for C in (1, 3, 8, 33, 96, 256, 4100, 16384) for n in (1, 4, 5)]
LRN_ROWS = 1001  # no tile (2048 elements) divides 1001 rows of these C
# softmax-xent at AlexNet's loss head: N=128 rows of C=1000 classes
ALEX_SXENT = (ALEX_B, 1000)
# training on the card against the same training on the CPU (B=8, dropout 0,
# 3 updates of one batch): each update's loss relative to the CPU's, and
# each param tensor's change from the seed params relative to the norm of
# the CPU's change (an update left out reads 1), after the first update (the
# gradient's accuracy) and after the third. Random labels make the
# gradients sums that cancel, and three steps of lr 1e-2 amplify rounding:
# f32 on the CPU against a f64 oracle reads loss 3.1e-4, first change
# 4.2e-3 and third 0.059; with LRN's backward missing its second term it
# reads 0.022, 0.166 and 0.389 (scripts/alexnet_train_sensitivity.py). In
# bf16 the rounding of the activations moves the changes by 0.27-0.29 of
# their norm, about what that fault does (0.32-0.43), but not the loss
# (3.1e-3 against 0.026). The card against the CPU read f32 1.5e-4, 3.4e-3
# and 0.091, bf16 loss 2.2e-3 (the fault on the card: f32 0.022, 0.166,
# 0.393, bf16 loss 0.026) on NVIDIA H100 80GB HBM3 at 700 W. The same faulty
# training runs on the card in the phase and must fail the limits: f32 on
# every reading, bf16 on the loss; bf16's changes are held only against an
# update left out or wrong (1).
ALEX_TRAIN_LIMITS = {
    "float32": {"loss_rel": 2e-3, "first_change_rel": 3e-2, "change_rel": 0.25},
    "bfloat16": {"loss_rel": 1e-2, "first_change_rel": 0.6, "change_rel": 0.6},
}
# kernel families of an AlexNet update, by a substring of their names
ALEX_PROFILE_GROUPS = [
    ("lrn, rows 3-4", r"lrn_(fwd|bwd)"), ("softmax_xent, rows 10-11", r"sxent_"),
    ("copies", r"(?i)memcpy|copy|transpose|nchwtonhwc|nhwctonchw"),
    ("convolution fprop", r"(?i)fprop|convolve"), ("convolution dgrad", r"(?i)dgrad"),
    ("convolution wgrad", r"(?i)wgrad"), ("fft", r"(?i)fft|cf32"),
    ("gemm", r"(?i)gemm|gemv"), ("max pool", r"(?i)max_pool"),
]
# served probabilities, card against CPU on 8 images: max |err| over max |p|
ALEX_SERVE_REL = {"float32": 1e-5, "bfloat16": 3e-2}
ALEX_TIMED = {"warmup": 2, "timed": 3}


def bound_lrn(shape, dtype: str, backward: bool, with_d: bool = True):
    """Rows 3-4 over x of ``shape``: the forward reads x and writes y (and d
    in training), n + 6 operations an element (x*x, n window adds, alpha*s
    and k + it, the power as two, x * it); the backward reads x, d and g and
    writes dx, n + 10 an element (g*x, its product with a power, n adds, a
    second power, g times it, (2ab)*x times the sum, the difference)."""
    import math

    elems = math.prod(shape)
    item = 4 if dtype == "float32" else 2
    if backward:
        return roofline(4 * elems * item, (LRN_N + 10.0) * elems, "float32")
    return roofline((3 if with_d else 2) * elems * item, (LRN_N + 6.0) * elems, "float32")


def lrn_inputs(torch, shape, dtype, seed, scale=30.0):
    """x at the scale of ReLU'd convolution outputs (where the window sums
    weigh on y and dx) and an upstream gradient g, on the card."""
    import numpy as np

    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    return (torch.as_tensor(rng.normal(0.0, scale, shape), dtype=dt, device=DEVICE),
            torch.as_tensor(rng.normal(0.0, 1.0, shape), dtype=dt, device=DEVICE))


def lrn_readings(got, want) -> dict:
    return {n: float((g.float() - w.float()).abs().max() / w.float().abs().max())
            for n, g, w in zip(("y", "y_serving", "d", "dx"), got, want)}


def lrn_offset_case(torch, lr, dtype: str, C: int, n: int, g_aligned: bool):
    """Rows 3-4 on views that start one element past 16 bytes: x and g (and
    so the forward's d), whose plan takes a head one element at a time and
    16-byte vectors after it; or x alone, g aligned, whose backward takes
    the narrow plan (one element an access). Returns (readings, finite,
    the forward's and the backward's plans)."""
    x, g = lrn_inputs(torch, (LRN_ROWS * C + 1,), dtype, SEED + C + n)
    x = x[1:].view(LRN_ROWS, C)
    g = g[1:].view(LRN_ROWS, C).clone() if g_aligned else g[1:].view(LRN_ROWS, C)
    args = (LRN_K, n, LRN_ALPHA, LRN_BETA)
    y, d = lr.lrn_forward(x, *args)
    y_serving, _ = lr.lrn_forward(x, *args, with_d=False)
    dx = lr.lrn_backward(x, d, g, *args)
    torch.cuda.synchronize()
    ry, rd = lr.lrn_reference(x, *args)
    rdx = lr.lrn_backward_reference(x, d, g, *args)
    got = (y, y_serving, d, dx)
    size = x.element_size()
    plans = [lr.plan(x.numel(), C, n, LRN_BETA, size, [t.data_ptr() for t in ts])
             for ts in ((x, y, d), (x, d, g, dx))]
    return (lrn_readings(got, (ry, ry, rd, rdx)),
            all(bool(torch.isfinite(t.float()).all()) for t in got), plans)


def phase_kernels_lrn(torch, lr, sx):
    """Rows 3-4 against their plain versions on the same CUDA tensors, f32
    and bf16: AlexNet's and GoogLeNet's two LRN shapes each (n=5), and C in
    LRN_CASES with n in
    {1, 4, 5} over 1001 rows; the training forward (y and d), the serving
    forward (y alone) and the backward from a random g. Views one element
    past 16 bytes (x and g; x alone). Then the two wrong plain versions,
    which the limits must catch, and softmax-xent (rows 10-11) at AlexNet's
    loss head, N=128, C=1000. Returns the max abs error of each kernel (f32,
    LRN 1's shape)."""
    errs, worst, n_cases = {}, {}, 0
    for dtype in ("float32", "bfloat16"):
        lim = LRN_REL[dtype]
        worst[dtype] = {}
        cases = [(shape, LRN_N) for shape in {**LRN_SHAPES, **GOOG_LRN_SHAPES}.values()]
        cases += [((LRN_ROWS, C), n) for C, n in LRN_CASES]
        for shape, n in cases:
            x, g = lrn_inputs(torch, shape, dtype, SEED + shape[-1] + n)
            y, d = lr.lrn_forward(x, LRN_K, n, LRN_ALPHA, LRN_BETA)
            y_serving, _ = lr.lrn_forward(x, LRN_K, n, LRN_ALPHA, LRN_BETA, with_d=False)
            dx = lr.lrn_backward(x, d, g, LRN_K, n, LRN_ALPHA, LRN_BETA)
            torch.cuda.synchronize()
            ry, rd = lr.lrn_reference(x, LRN_K, n, LRN_ALPHA, LRN_BETA)
            rdx = lr.lrn_backward_reference(x, rd, g, LRN_K, n, LRN_ALPHA, LRN_BETA)
            got, want = (y, y_serving, d, dx), (ry, ry, rd, rdx)
            e = lrn_readings(got, want)
            n_cases += 1
            for k, r in e.items():
                worst[dtype][k] = max(worst[dtype].get(k, 0.0), r)
            finite = all(bool(torch.isfinite(t.float()).all()) for t in got)
            check("lrn", dtype, e, dict.fromkeys(e, lim), shape=list(shape), n=n,
                  finite=finite, relative_to_largest=True)
            if not finite:
                raise AssertionError(f"lrn {dtype} {shape} n={n}: not finite")
            if shape == LRN_SHAPES["lrn1"] and dtype == "float32":
                errs[("lrn_fwd", dtype)] = max(
                    float((a.float() - b.float()).abs().max()) for a, b in zip(got[:3], want[:3]))
                errs[("lrn_bwd", dtype)] = float((dx.float() - rdx.float()).abs().max())
        for C, n in ((96, 5), (33, 4)):
            for g_aligned in (False, True):
                e, finite, plans = lrn_offset_case(torch, lr, dtype, C, n, g_aligned)
                n_cases += 1
                for k, r in e.items():
                    worst[dtype][k] = max(worst[dtype].get(k, 0.0), r)
                wide = 16 // (4 if dtype == "float32" else 2)
                want_plans = (plans[0].vec == wide and plans[0].head == wide - 1
                              and plans[1].vec == (1 if g_aligned else wide))
                check("lrn", dtype, e, dict.fromkeys(e, lim), shape=[LRN_ROWS, C], n=n,
                      view="x offset 1, g aligned" if g_aligned else "x and g offset 1",
                      plans=[p._asdict() for p in plans], finite=finite,
                      relative_to_largest=True)
                if not (finite and want_plans):
                    raise AssertionError(f"lrn {dtype} offset views C={C}: finite {finite}, "
                                         f"plans {plans}")
        # wrong plain versions: what a kernel that summed the backward over W
        # itself (not reflected; n=4), or left dx's second term out, reads
        x, g = lrn_inputs(torch, (LRN_ROWS, 96), dtype, SEED)
        ry, rd = lr.lrn_reference(x, LRN_K, 4, LRN_ALPHA, LRN_BETA)
        right = lr.lrn_backward_reference(x, rd, g, LRN_K, 4, LRN_ALPHA, LRN_BETA)
        c = lr._const
        t = g * x * rd ** float(c(-LRN_BETA - 1.0, x.dtype))
        first = g * rd ** float(c(-LRN_BETA, x.dtype))
        unreflected = first - c(2.0 * LRN_ALPHA * LRN_BETA, x.dtype) * x * lr._window_sum(
            t, 4, 4 // 2)
        wrong = {"window_not_reflected": float((unreflected.float() - right.float()).abs().max()
                                               / right.float().abs().max()),
                 "no_second_term": float((first.float() - right.float()).abs().max()
                                         / right.float().abs().max())}
        ok = all(v > lim for v in wrong.values())
        emit("kernel_limits", kernel="lrn", dtype=dtype, limit=lim, wrong_readings=wrong,
             caught=ok)
        if not ok:
            raise AssertionError(f"lrn {dtype}: the limit {lim} does not catch {wrong}")
        # rows 10-11 at AlexNet's (GoogLeNet's, ResNet-50's) loss head
        errs[("sxent_head", dtype)] = sxent_case(torch, sx, *ALEX_SXENT, dtype, "one_hot",
                                                 SEED + ALEX_SXENT[1])
    emit("kernels_lrn", cases=n_cases, worst_reading_by_dtype=worst, limits=LRN_REL,
         wrong_versions_caught=True, ok=True)
    return errs


def alexnet_params(conf, seed):
    """Random AlexNet weights from a numpy seed in the JAX package's layout
    (conv W [kh, kw, in, out], dense W [in, out]; {} for LRN and pooling):
    N(0, 0.01) as Krizhevsky et al. (2012) initialized them, and zero
    biases. At pixel-scale images, LRN 1 then sees activations of about 10,
    and three Nesterov updates of one batch lower its loss."""
    import numpy as np

    rng = np.random.default_rng(seed)
    params = []
    for layer, it in zip(conf.layers, conf.layer_input_types()):
        kind = type(layer).__name__
        if kind == "ConvolutionLayer":
            shape = (*layer.kernel, it.channels, layer.n_out)
        elif kind in ("DenseLayer", "OutputLayer"):
            shape = (it.flat_size(), layer.n_out)
        else:
            params.append({})
            continue
        params.append({"W": rng.normal(0.0, 0.01, shape), "b": np.zeros(layer.n_out)})
    return params


def alexnet_images(n, seed):
    """``n`` NHWC images of raw pixel values 0-255 and one-hot labels of
    1000 classes, from a numpy seed, as float32 host arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8).astype(np.float32)
    return x, one_hot(rng.integers(0, 1000, n), 1000)


def phase_serve_alexnet(torch, host, card):
    """``output`` and ``predict`` of AlexNet at B=128, f32 and bf16: shape,
    rows that sum to 1, predict as output's argmax, exactly 2 row-3 launches
    (the serving forward) and no other kernel per call; the card against the
    CPU on 8 of the images; host-clock ms of output(), median of 5. Returns
    the launch counts."""
    import numpy as np

    from deeplearning4j_tpu_torch import MultiLayerNetwork, alexnet_conf, load_jax_params, ops

    x, _ = alexnet_images(ALEX_B, SEED + 5)
    launches = {}
    for dtype in ("float32", "bfloat16"):
        conf = alexnet_conf(dtype=dtype)
        net = load_jax_params(MultiLayerNetwork(conf), host)
        per_call, results = {}, {}
        for call, fn in (("output", lambda: net.output(x)), ("predict", lambda: net.predict(x))):
            torch.cuda.synchronize()
            ops.reset_counters()
            results[call] = fn()
            torch.cuda.synchronize()
            per_call[call] = {k: v for k, v in ops.counters().items() if v}
        for counts in per_call.values():
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
        probs, cls = results["output"], results["predict"]
        cpu = load_jax_params(MultiLayerNetwork(conf, device="cpu"), host)
        t0 = time.perf_counter()
        cpu_probs = cpu.output(x[:ALEX_CPU_B])
        cpu_s = time.perf_counter() - t0
        cpu_err = float(np.abs(net.output(x[:ALEX_CPU_B]) - cpu_probs).max()
                        / np.abs(cpu_probs).max())
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            net.output(x)
            runs.append((time.perf_counter() - t0) * 1e3)
        ok = (probs.shape == (ALEX_B, 1000) and bool(np.isfinite(probs).all())
              and float(np.abs(probs.sum(-1) - 1.0).max()) < 1e-2
              and cls.shape == (ALEX_B,) and bool((cls == probs.argmax(-1)).all())
              and all(c == {"lrn_fwd": 2} for c in per_call.values())
              and cpu_err <= ALEX_SERVE_REL[dtype])
        emit("serve_alexnet", dtype=dtype, B=ALEX_B, shape=list(probs.shape),
             launches_per_call=per_call, max_err_vs_cpu_over_max_prob=cpu_err,
             cpu_batch=ALEX_CPU_B, limit=ALEX_SERVE_REL[dtype], cpu_output_s=cpu_s,
             top_prob_max=float(probs.max()),
             output_ms_runs=runs, output_ms_median=statistics.median(runs), ok=ok, gpu=card)
        if not ok:
            raise AssertionError(f"AlexNet serving {dtype} failed its checks")
    return launches


def named_tensors(params) -> dict:
    """A network's host params by "layer.key" (a list, one dict per layer)
    or "vertex.key" (a graph's dict by vertex name)."""
    items = params.items() if isinstance(params, dict) else enumerate(params)
    return {f"{n}.{k}": p[k] for n, p in items for k in p}


def train_readings(run, ref, seed_params) -> dict:
    """Training on the card against the CPU: each update's loss relative to
    the CPU's, and each tensor's change from the seed params relative to the
    norm of the CPU's change, after the first update and after the last
    (the largest over the tensors, and the tensor that reads it)."""
    import numpy as np

    seed = named_tensors(seed_params)

    def change(params, ref_params):
        mine, theirs = named_tensors(params), named_tensors(ref_params)
        by = {k: float(np.linalg.norm(mine[k] - q)
                       / np.linalg.norm(q - seed[k].astype(np.float32)))
              for k, q in theirs.items()}
        worst = max(by, key=by.get)
        return by[worst], worst

    losses, first, params = run
    ref_losses, ref_first, ref_params = ref
    first_rel, first_at = change(first, ref_first)
    last_rel, last_at = change(params, ref_params)
    return {"loss_rel": float(np.max(np.abs(losses - ref_losses) / np.abs(ref_losses))),
            "first_change_rel": first_rel, "change_rel": last_rel,
            "first_change_worst_tensor": first_at, "change_worst_tensor": last_at}


def resume_check(torch, net, data) -> dict:
    """A checkpoint of ``net`` written, restored on the card (the next
    update on ``data``, with cuDNN deterministic for both, exactly as the
    original's: params and layer state) and on the CPU (exactly the same
    params, updater trace and layer state)."""
    import os
    import tempfile

    import numpy as np

    from deeplearning4j_tpu_torch import params_to_numpy, restore_model, write_model

    def arrays(n):
        return list(named_tensors(params_to_numpy(n)).values())

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.zip")
        write_model(net, path)
        back = restore_model(path)
        on_cpu = restore_model(path, device="cpu")
    iterations = {"written": net.iteration, "cuda": back.iteration, "cpu": on_cpu.iteration}
    cpu_err = max(
        max(float(np.abs(p - q).max()) for p, q in zip(arrays(net), arrays(on_cpu))),
        max(float((a.float().cpu() - b.float()).abs().max()) for a, b in
            zip(net.updater_state_leaves() + net.state_leaves(),
                on_cpu.updater_state_leaves() + on_cpu.state_leaves())))
    torch.backends.cudnn.deterministic = True
    try:
        resumed = []
        for n in (net, back):
            n.fit(data)
            resumed.append((n.score(), arrays(n) + [t.cpu().numpy() for t in n.state_leaves()]))
    finally:
        torch.backends.cudnn.deterministic = False
    param_err = max(float(np.abs(p - q).max()) for p, q in zip(resumed[0][1], resumed[1][1]))
    loss_err = abs(resumed[0][0] - resumed[1][0])
    return dict(model_class=type(net).__name__, iterations=iterations,
                cpu_restore_max_abs_err=cpu_err, resume_max_param_abs_err=param_err,
                resume_loss_abs_err=loss_err, seconds=time.perf_counter() - t0,
                ok=(cpu_err == 0.0 and param_err == 0.0 and loss_err == 0.0
                    and len(set(iterations.values())) == 1))


def timed_fit(torch, net, batch, warmup, timed):
    """ms per ``fit`` of ``batch``, median of ``timed`` after ``warmup``
    updates (host clock, synchronized), the launch counts of the timed
    ones and their losses."""
    from deeplearning4j_tpu_torch import ops

    for _ in range(warmup):
        net.fit(batch)
    torch.cuda.synchronize()
    ops.reset_counters()
    times, losses = [], []
    for _ in range(timed):
        t0 = time.perf_counter()
        net.fit(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(net.score())
    return times, ops.counters(), losses


def phase_train_alexnet(torch, lr, dtype, host, card):
    """AlexNet's training from the seed params. The card against the CPU:
    the conf with dropout 0, Nesterov at lr 1e-2, 3 updates of one B=8
    batch (the loss must fall), held by ``train_readings``; the same on the
    card with LRN's backward missing its second term must fail the limits.
    ``evaluate`` on both; in f32, ``resume_check`` of the card's net. Then
    the conf itself (dropout 0.5) at B=128: exact launches per update, ms per
    update and images/s, median of 3 timed updates after 2 warm-up ones (the
    host's images, as ``fit`` takes them), and 3 more with the batch on the
    card. Returns (launch counts of the timed B=128 updates, ms per update,
    the B=128 net, its batch)."""
    import numpy as np

    from deeplearning4j_tpu_torch import (DataSet, MultiLayerNetwork, alexnet_conf,
                                          load_jax_params, params_to_numpy)

    lim = ALEX_TRAIN_LIMITS[dtype]
    x8, y8 = alexnet_images(ALEX_CPU_B, SEED + 6)
    conf0 = alexnet_conf(dtype=dtype, dropout=0.0)

    def train_small(dev):
        n = load_jax_params(MultiLayerNetwork(conf0, device=dev), host)
        r = LossRecorder()
        n.set_listeners(r)
        n.fit((x8, y8))
        first = params_to_numpy(n)
        for _ in range(ALEX_UPDATES - 1):
            n.fit((x8, y8))
        n.set_listeners()
        return n, np.array([float(l) for l in r.losses]), first, params_to_numpy(n)

    t0 = time.perf_counter()
    runs = {dev: train_small(dev) for dev in ("cuda", "cpu")}
    compared_s = time.perf_counter() - t0
    readings = train_readings(runs["cuda"][1:], runs["cpu"][1:], host)
    within = within_limits(readings, lim)
    real_bwd = lr.lrn_backward
    c = lr._const
    lr.lrn_backward = lambda x, d, g, k, n, a, b: g * d ** float(c(-b, x.dtype))
    try:
        fault = train_readings(train_small("cuda")[1:], runs["cpu"][1:], host)
    finally:
        lr.lrn_backward = real_bwd
    fault["caught"] = not within_limits(fault, lim)
    cpu_losses = runs["cpu"][1]
    loss_fall = float(cpu_losses[0] - cpu_losses[-1])
    card_fall = float(runs["cuda"][1][0] - runs["cuda"][1][-1])
    data = DataSet(x8, y8)
    acc = {dev: runs[dev][0].evaluate(data).accuracy() for dev in runs}

    # f32 only: the zip holds the same f32 master params in either dtype, and
    # writing and reading 62.4M params takes ~40 s
    resume = resume_check(torch, runs["cuda"][0], (x8, y8)) if dtype == "float32" else None

    # the conf itself (dropout 0.5) at B=128
    conf = alexnet_conf(dtype=dtype)
    net = load_jax_params(MultiLayerNetwork(conf), host)
    batch = alexnet_images(ALEX_B, SEED + 7)
    times, launches, losses = timed_fit(torch, net, batch, **ALEX_TIMED)
    timed = ALEX_TIMED["timed"]
    expected = dict.fromkeys(launches, 0)
    expected.update({"lrn_fwd": 2 * timed, "lrn_bwd": 2 * timed, "softmax_xent_fwd": timed,
                     "softmax_xent_bwd": timed})
    ms = statistics.median(times)
    # the same updates with the batch already on the card: what the host's
    # copy of the 77 MB of images costs an update
    on_card = tuple(torch.as_tensor(a, device=DEVICE) for a in batch)
    card_times, _, _ = timed_fit(torch, net, on_card, 0, timed)
    ok = (within and fault["caught"] and loss_fall > 0.0 and card_fall > 0.0
          and launches == expected and bool(np.isfinite(losses).all())
          and acc["cuda"] == acc["cpu"] and (resume is None or resume["ok"]))
    emit("train_alexnet", dtype=dtype, compared_batch=ALEX_CPU_B, compared_updates=ALEX_UPDATES,
         cpu_losses=cpu_losses.tolist(), card_losses=runs["cuda"][1].tolist(),
         cpu_loss_fall=loss_fall, readings_vs_cpu=readings, limits=lim,
         fault_lrn_bwd_without_second_term_vs_cpu=fault, compared_s=compared_s,
         evaluate_accuracy=acc, checkpoint=resume, B=ALEX_B, dropout=0.5,
         timed_losses=losses, kernel_launches=launches, expected_launches=expected,
         update_ms_runs=times, ms_per_update=ms, images_per_s=ALEX_B / (ms / 1e3),
         batch_on_card_ms_runs=card_times,
         batch_on_card_ms_per_update=statistics.median(card_times), ok=ok, gpu=card)
    if not ok:
        raise AssertionError(f"AlexNet training {dtype} failed its checks")
    return launches, ms, net, batch


# ---- the GoogLeNet slice: googlenet_conf() at its own widths (224x224x3
# images, 1000 classes; 6,998,552 params, 13,378,280 with the two auxiliary
# heads), a ComputationGraph of 9 inception merges; B=128 as AlexNet's, the
# conf's Nesterov at lr 1e-2 and dropout 0.4. Its two LRN layers run rows 3-4
# at [B, 56, 56, 64] and [B, 56, 56, 192], each head rows 10-11 at N=B,
# C=1000. Images and labels are synthetic, as AlexNet's; every head of the
# graph learns the same labels.
GOOG_B, GOOG_CPU_B, GOOG_UPDATES = 128, 4, 3
GOOG_LRN_SHAPES = {"googlenet_lrn1": (GOOG_B, 56, 56, 64),
                   "googlenet_lrn2": (GOOG_B, 56, 56, 192)}
# training on the card against the same training on the CPU (B=4, dropout 0,
# the aux heads on, 3 updates of one batch), read as AlexNet's
# (train_readings). The limits sit between what the right training reads and
# what the phase's two wrong versions read on the card: a MergeVertex that
# swaps its last two branches (the same channels in total, so every shape
# holds) and LRN's backward without its second term. On the CPU against a
# float64 oracle (scripts/googlenet_train_sensitivity.py) f32 reads loss
# 7.6e-8, first change 8.4e-4, third 4.1e-3; with the swapped merge 2.9e-3,
# 2.20, 1.90; without LRN's second term 3.4e-5, 0.56, 1.12. bf16 reads 1.2e-4,
# 0.19, 0.099; 2.7e-3, 2.22, 1.90; 1.4e-4, 0.59, 1.11. So each dtype holds
# both faults by the changes (bf16's first change only the merge: its own
# rounding moves it by a third of what the LRN fault does), and the loss only
# an update gone wrong.
GOOG_TRAIN_LIMITS = {
    "float32": {"loss_rel": 1e-3, "first_change_rel": 5e-2, "change_rel": 0.1},
    "bfloat16": {"loss_rel": 1e-2, "first_change_rel": 0.6, "change_rel": 0.4},
}
GOOG_FAULTS = ("merge_branches_swapped", "lrn_bwd_without_second_term")
# served probabilities, card against CPU on 4 images: max |err| over max |p|
GOOG_SERVE_REL = {"float32": 1e-5, "bfloat16": 3e-2}


def googlenet_params(conf, seed):
    """Random GoogLeNet weights from a numpy seed, vertex name -> {"W", "b"}
    in the JAX package's layout (conv W [kh, kw, in, out], dense W [in,
    out]), drawn in topological order: convolutions N(0, 1/(2 fan_in)), the
    aux heads' dense layers N(0, 2/fan_in), the output layers N(0, 0.01^2),
    zero biases. On pixel-scale images both LRN layers then see inputs whose
    window sums weigh on y (the phase's LRN fault shows it), and three
    Nesterov updates at lr 1e-2 lower the loss."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vit = conf.vertex_input_types()
    params = {}
    for name in conf.topological_order():
        layer = getattr(conf.vertices[name], "layer", None)
        kind, it = type(layer).__name__, vit[name][0]
        if kind == "ConvolutionLayer":
            shape = (*layer.kernel, it.channels, layer.n_out)
            std = np.sqrt(0.5 / np.prod(shape[:3]))
        elif kind in ("DenseLayer", "OutputLayer"):
            shape = (it.flat_size(), layer.n_out)
            std = np.sqrt(2.0 / shape[0]) if kind == "DenseLayer" else 0.01
        else:
            continue
        params[name] = {"W": rng.normal(0.0, std, shape), "b": np.zeros(layer.n_out)}
    return params


def googlenet_net(conf, host, device=DEVICE):
    """A ComputationGraph of ``conf`` holding ``host``'s params of its
    vertices."""
    from deeplearning4j_tpu_torch import ComputationGraph, load_jax_params

    return load_jax_params(ComputationGraph(conf, device=device),
                           {n: p for n, p in host.items() if n in conf.vertices})


def phase_serve_googlenet(torch, host, card):
    """``output`` and ``predict`` of GoogLeNet (the conf as it is) at
    B=128, f32 and bf16: shape, rows that sum to 1, predict as output's
    argmax, exactly 2 row-3 launches (the serving forward) and no other
    kernel per call; the card against the CPU on 4 of the images; host-clock
    ms of output(), median of 5. Returns the launch counts."""
    import numpy as np

    from deeplearning4j_tpu_torch import googlenet_conf, ops

    x, _ = alexnet_images(GOOG_B, SEED + 8)
    launches = {}
    for dtype in ("float32", "bfloat16"):
        conf = googlenet_conf(dtype=dtype)
        net = googlenet_net(conf, host)
        per_call, results = {}, {}
        for call, fn in (("output", lambda: net.output(x)), ("predict", lambda: net.predict(x))):
            torch.cuda.synchronize()
            ops.reset_counters()
            results[call] = fn()
            torch.cuda.synchronize()
            per_call[call] = {k: v for k, v in ops.counters().items() if v}
        for counts in per_call.values():
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
        probs, cls = results["output"], results["predict"]
        t0 = time.perf_counter()
        cpu_probs = googlenet_net(conf, host, "cpu").output(x[:GOOG_CPU_B])
        cpu_s = time.perf_counter() - t0
        cpu_err = float(np.abs(net.output(x[:GOOG_CPU_B]) - cpu_probs).max()
                        / np.abs(cpu_probs).max())
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            net.output(x)
            runs.append((time.perf_counter() - t0) * 1e3)
        ok = (probs.shape == (GOOG_B, 1000) and bool(np.isfinite(probs).all())
              and float(np.abs(probs.sum(-1) - 1.0).max()) < 1e-2
              and cls.shape == (GOOG_B,) and bool((cls == probs.argmax(-1)).all())
              and all(c == {"lrn_fwd": 2} for c in per_call.values())
              and cpu_err <= GOOG_SERVE_REL[dtype])
        emit("serve_googlenet", dtype=dtype, B=GOOG_B, shape=list(probs.shape),
             launches_per_call=per_call, max_err_vs_cpu_over_max_prob=cpu_err,
             cpu_batch=GOOG_CPU_B, limit=GOOG_SERVE_REL[dtype], cpu_output_s=cpu_s,
             top_prob_max=float(probs.max()), output_ms_runs=runs,
             output_ms_median=statistics.median(runs), ok=ok, gpu=card)
        if not ok:
            raise AssertionError(f"GoogLeNet serving {dtype} failed its checks")
    return launches


def swapped_merge(torch):
    """A wrong MergeVertex.apply: its last two branches swapped."""
    def apply(self, params, inputs, state, *, train=False, generator=None, masks=None):
        ins = list(inputs)
        ins[-2], ins[-1] = ins[-1], ins[-2]
        return torch.cat(ins, dim=-1), state
    return apply


def phase_train_googlenet(torch, lr, dtype, host, card):
    """GoogLeNet's training from the seed params. The card against the CPU:
    the conf with dropout 0 and the two aux heads, Nesterov at lr 1e-2, 3
    updates of one B=4 batch (the loss must fall), held by
    ``train_readings``; exactly 2 + 2 LRN launches and one softmax-xent
    forward and backward per head per update; the same on the card with a
    wrong version (each of GOOG_FAULTS) must fail the limits. ``evaluate`` (one
    Evaluation a head) on both; in f32, ``resume_check`` of the card's net.
    Then the conf itself (dropout 0.4, one head) at B=128: exact launches
    per update, ms per update and images/s, median of 3 timed updates after
    2 warm-up ones (the host's images, as ``fit`` takes them), and 3 more
    with the batch on the card. Returns (launch counts of the B=4 and timed
    B=128 updates, ms per update, the B=128 net, its batch)."""
    import numpy as np

    from deeplearning4j_tpu_torch import MultiDataSet, googlenet_conf, ops, params_to_numpy
    from deeplearning4j_tpu_torch.nn.graph import vertices

    lim = GOOG_TRAIN_LIMITS[dtype]
    x4, y4 = alexnet_images(GOOG_CPU_B, SEED + 9)
    small = MultiDataSet([x4], [y4] * 3)
    conf0 = googlenet_conf(dtype=dtype, dropout=0.0, aux_heads=True)
    heads = len(conf0.network_outputs)

    def train_small(dev):
        n = googlenet_net(conf0, host, dev)
        r = LossRecorder()
        n.set_listeners(r)
        n.fit(small)
        first = params_to_numpy(n)
        for _ in range(GOOG_UPDATES - 1):
            n.fit(small)
        n.set_listeners()
        return n, np.array([float(l) for l in r.losses]), first, params_to_numpy(n)

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    ops.reset_counters()
    runs = {"cuda": train_small("cuda")}
    torch.cuda.synchronize()
    small_launches = ops.counters()
    runs["cpu"] = train_small("cpu")
    compared_s = time.perf_counter() - t0
    small_expected = dict.fromkeys(small_launches, 0)
    small_expected.update({"lrn_fwd": 2 * GOOG_UPDATES, "lrn_bwd": 2 * GOOG_UPDATES,
                           "softmax_xent_fwd": heads * GOOG_UPDATES,
                           "softmax_xent_bwd": heads * GOOG_UPDATES})
    readings = train_readings(runs["cuda"][1:], runs["cpu"][1:], host)
    within = within_limits(readings, lim)
    faults = {}
    for fault in GOOG_FAULTS:
        real_bwd, real_merge = lr.lrn_backward, vertices.MergeVertex.apply
        c = lr._const
        if fault == "merge_branches_swapped":
            vertices.MergeVertex.apply = swapped_merge(torch)
        else:
            lr.lrn_backward = lambda x, d, g, k, n, a, b: g * d ** float(c(-b, x.dtype))
        try:
            faults[fault] = train_readings(train_small("cuda")[1:], runs["cpu"][1:], host)
        finally:
            lr.lrn_backward, vertices.MergeVertex.apply = real_bwd, real_merge
        faults[fault]["caught"] = not within_limits(faults[fault], lim)
    cpu_losses = runs["cpu"][1]
    loss_fall = float(cpu_losses[0] - cpu_losses[-1])
    card_fall = float(runs["cuda"][1][0] - runs["cuda"][1][-1])
    acc = {dev: {h: ev.accuracy() for h, ev in runs[dev][0].evaluate(small).items()}
           for dev in runs}
    resume = resume_check(torch, runs["cuda"][0], small) if dtype == "float32" else None

    # the conf itself (dropout 0.4, the main head) at B=128
    net = googlenet_net(googlenet_conf(dtype=dtype), host)
    batch = alexnet_images(GOOG_B, SEED + 10)
    times, timed_launches, losses = timed_fit(torch, net, batch, **ALEX_TIMED)
    timed = ALEX_TIMED["timed"]
    expected = dict.fromkeys(timed_launches, 0)
    expected.update({"lrn_fwd": 2 * timed, "lrn_bwd": 2 * timed, "softmax_xent_fwd": timed,
                     "softmax_xent_bwd": timed})
    ms = statistics.median(times)
    on_card = tuple(torch.as_tensor(a, device=DEVICE) for a in batch)
    card_times, _, _ = timed_fit(torch, net, on_card, 0, timed)
    ok = (within and all(f["caught"] for f in faults.values()) and loss_fall > 0.0
          and card_fall > 0.0 and small_launches == small_expected
          and timed_launches == expected and bool(np.isfinite(losses).all())
          and acc["cuda"] == acc["cpu"] and (resume is None or resume["ok"]))
    emit("train_googlenet", dtype=dtype, compared_batch=GOOG_CPU_B,
         compared_updates=GOOG_UPDATES, heads=conf0.network_outputs,
         cpu_losses=cpu_losses.tolist(), card_losses=runs["cuda"][1].tolist(),
         cpu_loss_fall=loss_fall, readings_vs_cpu=readings, limits=lim,
         faults_vs_cpu=faults, compared_s=compared_s, compared_launches=small_launches,
         compared_expected_launches=small_expected, evaluate_accuracy=acc,
         checkpoint=resume, B=GOOG_B, dropout=0.4, timed_losses=losses,
         kernel_launches=timed_launches, expected_launches=expected, update_ms_runs=times,
         ms_per_update=ms, images_per_s=GOOG_B / (ms / 1e3), batch_on_card_ms_runs=card_times,
         batch_on_card_ms_per_update=statistics.median(card_times),
         batch_on_card_images_per_s=GOOG_B / (statistics.median(card_times) / 1e3),
         ok=ok, gpu=card)
    if not ok:
        raise AssertionError(f"GoogLeNet training {dtype} failed its checks")
    launches = {k: small_launches.get(k, 0) + timed_launches.get(k, 0)
                for k in set(small_launches) | set(timed_launches)}
    return launches, ms, net, batch


# ---- the ResNet slice: resnet50_conf() at its own widths and bench.py:180's
# shape (B=128, 224x224x3 images, 1000 classes; 25,557,032 params; 53
# BatchNormalization layers, whose running mean and variance are 106 state
# tensors of 53,120 elements), a ComputationGraph of 174 vertices with 16
# residual adds, the conf's SGD at lr 0.1. Its head runs rows 10-11 at N=B,
# C=1000. Images and labels are synthetic, as AlexNet's.
RES_B, RES_CPU_B, RES_SERVE_CPU_B, RES_UPDATES = 128, 4, 2, 3
# served probabilities, card against CPU on 2 images, eval-mode BN on a
# state that is not the initial one: max |err| over max |p|. Read on the
# H100: f32 1.4e-5, bf16 3.8e-2 (53 layers of convolutions and BN, running
# variances up to 1.6e4). On the CPU (f32 as the reference) bf16 itself
# reads 0.17, the running stats replaced by the batch's 0.16, the initial
# state 273. bf16's limit sits midway (in the logs) between its right
# reading and that wrong one, which the phase runs on the card and must
# fail (read there: f32 0.157, bf16 0.191): the limits hold the card to
# its dtype's rounding
RES_SERVE_REL = {"float32": 1e-4, "bfloat16": 0.08}
# training on the card against the same training on the CPU (B=4, 3 updates
# of one batch, the conf's lr 0.1), held by resnet_readings where it is
# well conditioned: the first update. Set from the CPU against float64
# (scripts/resnet_train_sensitivity.py): f32 reads a first loss of 1.0e-6,
# each tensor's first change 0.023 (median over the 161 tensors) to 0.034,
# the first running stats 7.8e-6, a var factor of 1.9e-5 and an eval score
# of 5.2e-7; bf16 9.1e-3, 1.32 to 1.67, 0.045, 0.34 and 6.9e-4. bf16's
# change cannot be held tighter: its forward's pooled features are 12% off
# float64's, 87% of their part that differs from image to image, so its
# gradients are uncorrelated with float64's (sqrt 2 = 1.41 for two
# independent ones), at B=16 as at B=4 (f32 0.020 to 0.024, bf16 1.31 to
# 2.29), and at any lr (the first change does not depend on it). The
# later updates are read and not held: after the first the trajectory
# moves with the rounding at every lr tried (f32's last change reads 1.59
# at lr 0.1 and 0.98 at lr 0.001), so the phase holds only that the loss
# falls.
# Wrong, both dtypes: BN's variance unbiased reads a var factor of 1.0 and
# 1.34 (f32 a first state of 1.8e-3 and an eval score of 2.7e-3 too); the
# decay swapped a first state of 8.0; eval on batch stats an eval score of
# 0.998; the shortcut dropped a first change of 40 and 47 (f32 a first
# loss of 6.3e-3).
RES_TRAIN_LIMITS = {
    "float32": {"first_loss_rel": 1e-5, "first_change_rel": 0.1, "first_state_rel": 1e-4,
                "first_var_factor": 1e-3, "eval_score_rel": 1e-5},
    "bfloat16": {"first_loss_rel": 2e-2, "first_change_rel": 3.0, "first_state_rel": 0.15,
                 "first_var_factor": 0.5, "eval_score_rel": 1e-2},
}
RES_FAULTS = ("bn_running_var_unbiased", "bn_decay_swapped", "bn_eval_on_batch_stats",
              "shortcut_dropped")
RES_PROFILE_GROUPS = ALEX_PROFILE_GROUPS[1:-2] + [
    ("convolution, cutlass and xmma kernels", r"(?i)cutlass|xmma"),
    *ALEX_PROFILE_GROUPS[-2:], ("reductions (BN stats, pools)", r"(?i)reduce"),
    ("elementwise (BN, relu, adds, SGD)", r"(?i)elementwise")]


def resnet_params(conf, seed):
    """Random ResNet weights from a numpy seed, vertex name -> dict in the
    JAX package's layout, drawn in topological order: convolutions
    N(0, 2/fan_in) (the conf's "relu" init; no bias), BatchNormalization's
    gamma 1 and beta 0 (the conf's init), the output layer N(0, 0.01^2)
    with a zero bias."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vit = conf.vertex_input_types()
    params = {}
    for name in conf.topological_order():
        layer = getattr(conf.vertices[name], "layer", None)
        kind, it = type(layer).__name__, vit[name][0]
        if kind == "ConvolutionLayer":
            shape = (*layer.kernel, it.channels, layer.n_out)
            params[name] = {"W": rng.normal(0.0, np.sqrt(2.0 / np.prod(shape[:3])), shape)}
        elif kind == "BatchNormalization":
            params[name] = {"gamma": np.ones(it.channels), "beta": np.zeros(it.channels)}
        elif kind == "OutputLayer":
            params[name] = {"W": rng.normal(0.0, 0.01, (it.flat_size(), layer.n_out)),
                            "b": np.zeros(layer.n_out)}
    return params


def resnet_net(conf, host, state=None, device=DEVICE):
    """A ComputationGraph of ``conf`` holding ``host``'s params and, given
    ``state``, that layer state."""
    from deeplearning4j_tpu_torch import ComputationGraph, load_jax_params

    return load_jax_params(ComputationGraph(conf, device=device), host, state=state)


def resnet_serving_state(host):
    """A layer state that is not the initial one: the batch stats of 4
    images of their own seed, taken on the card by one ``fit`` of the conf
    with every BN's decay 0 and SGD at lr 0 (the params stay as they
    are)."""
    from deeplearning4j_tpu_torch import BatchNormalization, UpdaterConfig, resnet50_conf
    from deeplearning4j_tpu_torch import state_to_numpy

    conf = resnet50_conf(updater=UpdaterConfig(updater="sgd", learning_rate=0.0))
    for vertex in conf.vertices.values():
        if isinstance(getattr(vertex, "layer", None), BatchNormalization):
            vertex.layer.decay = 0.0
    net = resnet_net(conf, host)
    net.fit(alexnet_images(RES_CPU_B, SEED + 14))
    return state_to_numpy(net)


def phase_serve_resnet50(torch, host, state, card):
    """``output`` and ``predict`` of ResNet-50 (the conf as it is) at B=128,
    f32 and bf16, with the running stats of ``state`` (mean != 0, var != 1,
    so eval-mode BN is held): shape, rows that sum to 1, predict as
    output's argmax, no hand-kernel launch a call; the card against the
    CPU on 2 of the images, and the card under the wrong eval-mode BN
    (normalizing by the batch's stats) failing that limit; host-clock ms
    of output(), median of 5."""
    import numpy as np

    from deeplearning4j_tpu_torch import ops, resnet50_conf

    x, _ = alexnet_images(RES_B, SEED + 11)
    means = np.concatenate([s["mean"] for s in state.values() if s])
    varis = np.concatenate([s["var"] for s in state.values() if s])
    for dtype in ("float32", "bfloat16"):
        conf = resnet50_conf(dtype=dtype)
        net = resnet_net(conf, host, state)
        per_call, results = {}, {}
        for call, fn in (("output", lambda: net.output(x)), ("predict", lambda: net.predict(x))):
            torch.cuda.synchronize()
            ops.reset_counters()
            results[call] = fn()
            torch.cuda.synchronize()
            per_call[call] = {k: v for k, v in ops.counters().items() if v}
        probs, cls = results["output"], results["predict"]
        t0 = time.perf_counter()
        cpu_probs = resnet_net(conf, host, state, "cpu").output(x[:RES_SERVE_CPU_B])
        cpu_s = time.perf_counter() - t0
        cpu_err = float(np.abs(net.output(x[:RES_SERVE_CPU_B]) - cpu_probs).max()
                        / np.abs(cpu_probs).max())
        undo = resnet_fault("bn_eval_on_batch_stats")
        try:
            wrong_err = float(np.abs(net.output(x[:RES_SERVE_CPU_B]) - cpu_probs).max()
                              / np.abs(cpu_probs).max())
        finally:
            undo()
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            net.output(x)
            runs.append((time.perf_counter() - t0) * 1e3)
        ok = (probs.shape == (RES_B, 1000) and bool(np.isfinite(probs).all())
              and float(np.abs(probs.sum(-1) - 1.0).max()) < 1e-2
              and cls.shape == (RES_B,) and bool((cls == probs.argmax(-1)).all())
              and all(c == {} for c in per_call.values())
              and float(np.abs(means).max()) > 0.0 and float(np.abs(varis - 1.0).max()) > 0.0
              and cpu_err <= RES_SERVE_REL[dtype] < wrong_err)
        emit("serve_resnet50", dtype=dtype, B=RES_B, shape=list(probs.shape),
             launches_per_call=per_call, state_mean_abs_max=float(np.abs(means).max()),
             state_var_range=[float(varis.min()), float(varis.max())],
             max_err_vs_cpu_over_max_prob=cpu_err, cpu_batch=RES_SERVE_CPU_B,
             eval_on_batch_stats_vs_cpu=wrong_err,
             limit=RES_SERVE_REL[dtype], cpu_output_s=cpu_s, top_prob_max=float(probs.max()),
             output_ms_runs=runs, output_ms_median=statistics.median(runs), ok=ok, gpu=card)
        if not ok:
            raise AssertionError(f"ResNet-50 serving {dtype} failed its checks")


def bn_fault(fault: str, real):
    """A wrong BatchNormalization.apply around the right one (``real``):
    the running variance updated from the unbiased batch variance
    (torch's convention), the decay the wrong way round (0.1*old +
    0.9*batch), or eval mode normalizing by the batch's stats."""
    def apply(self, params, x, state, *, mask=None, train=False, generator=None):
        if not train:
            if fault == "bn_eval_on_batch_stats":
                return real(self, params, x, state, mask=mask, train=True,
                            generator=generator)[0], state
            return real(self, params, x, state, mask=mask, train=False, generator=generator)
        y, new = real(self, params, x, state, mask=mask, train=True, generator=generator)
        d = self.decay
        batch = {k: (new[k] - d * state[k]) / (1 - d) for k in new}
        if fault == "bn_running_var_unbiased":
            n = x.numel() // x.shape[-1]
            new = {"mean": new["mean"],
                   "var": d * state["var"] + (1 - d) * batch["var"] * (n / (n - 1))}
        elif fault == "bn_decay_swapped":
            new = {k: (1 - d) * state[k] + d * batch[k] for k in new}
        return y, new
    return apply


def dropped_shortcut(real):
    """A wrong ElementWiseVertex.apply: "add" returns its first input (a
    block's branch) and drops the second (the shortcut)."""
    def apply(self, params, inputs, state, *, train=False, generator=None, masks=None):
        if self.op == "add":
            return inputs[0], state
        return real(self, params, inputs, state, train=train, generator=generator, masks=masks)
    return apply


def resnet_fault(fault):
    """Install ``fault`` (one of RES_FAULTS, or None); returns the undo."""
    from deeplearning4j_tpu_torch import BatchNormalization
    from deeplearning4j_tpu_torch.nn.graph import vertices

    real_bn, real_add = BatchNormalization.apply, vertices.ElementWiseVertex.apply
    if fault == "shortcut_dropped":
        vertices.ElementWiseVertex.apply = dropped_shortcut(real_add)
    elif fault is not None:
        BatchNormalization.apply = bn_fault(fault, real_bn)

    def undo():
        BatchNormalization.apply, vertices.ElementWiseVertex.apply = real_bn, real_add
    return undo


def resnet_train_run(conf, host, batch, device, fault=None, updates=RES_UPDATES):
    """``updates`` updates of one batch from the seed params on ``device``
    under ``fault``: the net, the losses, the params and the layer state
    after the first and the last update, the eval-mode score (the loss on
    the batch with the running stats) of the seed params with the state
    after the first update, the kernel launches of the updates, and each
    BN layer's values a channel and decay."""
    import numpy as np

    from deeplearning4j_tpu_torch import ops, params_to_numpy, state_to_numpy

    undo = resnet_fault(fault)
    try:
        net = resnet_net(conf, host, device=device)
        rec = LossRecorder()
        net.set_listeners(rec)
        ops.reset_counters()
        net.fit(batch)
        first, first_state = params_to_numpy(net), state_to_numpy(net)
        for _ in range(updates - 1):
            net.fit(batch)
        launches = ops.counters()
        net.set_listeners()
        vit = conf.vertex_input_types()
        bn = {n: (len(batch[0]) * vit[n][0].height * vit[n][0].width,
                  conf.vertices[n].layer.decay) for n, s in first_state.items() if s}
        return dict(net=net, losses=np.array([float(l) for l in rec.losses]), first=first,
                    first_state=first_state, params=params_to_numpy(net),
                    state=state_to_numpy(net),
                    eval_score=resnet_net(conf, host, first_state, device).score(batch),
                    launches=launches, bn=bn)
    finally:
        undo()


def state_rel(state, ref) -> float:
    """The largest ||state - ref's|| / ||ref's|| over the running means and
    variances."""
    import numpy as np

    return max(float(np.linalg.norm(state[n][k] - s[k]) / np.linalg.norm(s[k]))
               for n, s in ref.items() for k in s)


def resnet_readings(run, ref, host) -> dict:
    """``train_readings`` of the params and losses, and: ``first_loss_rel``,
    the first update's loss (the forward at the seed params) relative to
    the ref's; ``first_state_rel`` and ``state_rel``, the running stats
    after the first and the last update; ``first_var_factor``, the batch
    variances that the first update added to the running ones, (var -
    decay) / (1 - decay) summed over each BN's channels, fitted to the
    ref's as (1 + k/(n-1)) over the BN layers, n each one's values a
    channel (least squares in the logs): the unbiased variance reads k = 1,
    the biased one 0 plus rounding, which varies from layer to layer where
    the factor does not; ``eval_score_rel``, the eval-mode score of the
    seed params with the first update's running stats relative to the
    ref's. RES_TRAIN_LIMITS hold the first update's readings; the later
    ones (``loss_rel``, ``change_rel``, ``state_rel``) move with the
    rounding at every lr (PERF.md) and are only reported."""
    import numpy as np

    out = train_readings((run["losses"], run["first"], run["params"]),
                         (ref["losses"], ref["first"], ref["params"]), host)
    out["first_loss_rel"] = float(abs(run["losses"][0] - ref["losses"][0])
                                  / abs(ref["losses"][0]))
    out["first_state_rel"] = state_rel(run["first_state"], ref["first_state"])
    out["state_rel"] = state_rel(run["state"], ref["state"])
    w, z = [], []
    for n, (count, decay) in ref["bn"].items():  # the running var starts at 1
        added = [np.sum(st[n]["var"].astype(np.float64) - decay) / (1 - decay)
                 for st in (run["first_state"], ref["first_state"])]
        w.append(np.log(count / (count - 1.0)))
        z.append(np.log(added[0] / added[1]) if added[0] / added[1] > 0 else np.inf)
    out["first_var_factor"] = abs(float(np.dot(w, z) / np.dot(w, w)))
    out["eval_score_rel"] = abs(run["eval_score"] - ref["eval_score"]) / abs(ref["eval_score"])
    return out


def phase_train_resnet50(torch, dtype, host, card):
    """ResNet-50's training from the seed params. The card against the CPU:
    3 SGD updates of one B=4 batch (the loss must fall), held by
    ``resnet_readings``; exactly one softmax-xent forward and backward per
    update and no other hand-kernel launch; the same on the card under
    each of RES_FAULTS must fail the limits. ``evaluate`` on both; in f32
    ``resume_check`` of the card's net (params, updater and layer state
    through a zip). Then the conf itself at B=128 (an out-of-memory error
    fails the phase): ms per update and images/s, median of 3 after 2
    warm-ups, from the host's images and with the batch on the
    card; the peak of allocated memory; one profiled update. Returns the
    launch counts of both parts and the B=128 ms per update."""
    import numpy as np

    from deeplearning4j_tpu_torch import resnet50_conf

    lim = RES_TRAIN_LIMITS[dtype]
    conf = resnet50_conf(dtype=dtype)
    small = alexnet_images(RES_CPU_B, SEED + 12)
    t0 = time.perf_counter()
    runs = {"cuda": resnet_train_run(conf, host, small, "cuda")}
    small_launches = runs["cuda"]["launches"]
    runs["cpu"] = resnet_train_run(conf, host, small, "cpu")
    readings = resnet_readings(runs["cuda"], runs["cpu"], host)
    within = within_limits(readings, lim)
    faults = {}
    for fault in RES_FAULTS:
        faults[fault] = resnet_readings(resnet_train_run(conf, host, small, "cuda", fault),
                                        runs["cpu"], host)
        faults[fault]["caught"] = not within_limits(faults[fault], lim)
    compared_s = time.perf_counter() - t0
    small_expected = dict.fromkeys(small_launches, 0)
    small_expected.update({"softmax_xent_fwd": RES_UPDATES, "softmax_xent_bwd": RES_UPDATES})
    cpu_losses, card_losses = runs["cpu"]["losses"], runs["cuda"]["losses"]
    acc = {dev: runs[dev]["net"].evaluate(small).accuracy() for dev in runs}
    resume = resume_check(torch, runs["cuda"]["net"], small) if dtype == "float32" else None
    del runs

    # the conf itself at B=128
    torch.cuda.empty_cache()
    net = resnet_net(conf, host)
    batch = alexnet_images(RES_B, SEED + 13)
    torch.cuda.reset_peak_memory_stats()
    times, timed_launches, losses = timed_fit(torch, net, batch, **ALEX_TIMED)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    timed = ALEX_TIMED["timed"]
    expected = dict.fromkeys(timed_launches, 0)
    expected.update({"softmax_xent_fwd": timed, "softmax_xent_bwd": timed})
    ms = statistics.median(times)
    on_card = tuple(torch.as_tensor(a, device=DEVICE) for a in batch)
    card_times, _, _ = timed_fit(torch, net, on_card, 0, timed)
    prof = profile(torch, lambda: net.fit(on_card), top=14, groups=RES_PROFILE_GROUPS)
    emit("profile", what=f"fit() one SGD update of ResNet-50, {dtype} B={RES_B}, batch on "
         "the card", gpu=card, **prof)
    ok = (within and all(f["caught"] for f in faults.values())
          and cpu_losses[1] < cpu_losses[0] and card_losses[1] < card_losses[0]
          and small_launches == small_expected and timed_launches == expected
          and bool(np.isfinite(losses).all()) and acc["cuda"] == acc["cpu"]
          and (resume is None or resume["ok"]))
    emit("train_resnet50", dtype=dtype, compared_batch=RES_CPU_B, compared_updates=RES_UPDATES,
         cpu_losses=cpu_losses.tolist(), card_losses=card_losses.tolist(),
         readings_vs_cpu=readings, limits=lim, faults_vs_cpu=faults, compared_s=compared_s,
         compared_launches=small_launches, compared_expected_launches=small_expected,
         evaluate_accuracy=acc, checkpoint=resume, B=RES_B,
         timed_losses=losses, kernel_launches=timed_launches, expected_launches=expected,
         update_ms_runs=times, ms_per_update=ms, images_per_s=RES_B / (ms / 1e3),
         batch_on_card_ms_runs=card_times,
         batch_on_card_ms_per_update=statistics.median(card_times),
         batch_on_card_images_per_s=RES_B / (statistics.median(card_times) / 1e3),
         peak_allocated_gib=peak_gb, idle_share=prof["idle_share"], ok=ok, gpu=card)
    if not ok:
        raise AssertionError(f"ResNet-50 training {dtype} failed its checks")
    del net, on_card
    torch.cuda.empty_cache()
    return {k: small_launches.get(k, 0) + timed_launches.get(k, 0)
            for k in set(small_launches) | set(timed_launches)}, ms


# ---- the MNIST slice: LeNet (lenet_mnist_conf(): 28x28x1, Adam at lr 1e-3;
# 431,080 params in 8 leaves) at dl4j-examples' LenetMnistExample batch of
# 64, and examples/mlp_mnist.py:26-34's MLP (Dense 256 relu, softmax head,
# Adam 1e-3, seed 123; 203,530 params in 4 leaves) at bench_mlp_mnist's
# B=512, both on MultiLayerNetwork over MnistDataSetIterator's synthetic
# MNIST (MNIST itself needs a download). Each update runs rows 10-11 at
# N=B, C=10 and one row-12 launch.
MNIST_UPDATES, MNIST_TIMED = 4, {"warmup": 2, "timed": 5}
# the card against the CPU, read as the char-RNN recipe's Adam
# (recipe_readings, whose f32 limits these are): Adam's step is +-lr
# wherever a gradient sits near 0, so params are held by their change and
# by counts; a wrong Adam (RECIPE_FAULTS) must fail them
MNIST_LIMITS = RECIPE_LIMITS["float32"]


def mnist_models():
    """name -> (batch, conf) of the two MNIST models."""
    from deeplearning4j_tpu_torch import (DenseLayer, InputType, MultiLayerConfiguration,
                                          OutputLayer, UpdaterConfig, lenet_mnist_conf)

    mlp = MultiLayerConfiguration(
        layers=[DenseLayer(n_out=256, activation="relu"),
                OutputLayer(n_out=10, activation="softmax", loss="mcxent")],
        input_type=InputType.feed_forward(784),
        updater=UpdaterConfig(updater="adam", learning_rate=1e-3).to_dict(), seed=123)
    return {"lenet": (64, lenet_mnist_conf()), "mlp": (512, mlp)}


def conf_host(conf):
    """The port's own initial params of ``conf`` (drawn from conf.seed on the
    CPU) as host arrays."""
    from deeplearning4j_tpu_torch import MultiLayerNetwork, params_to_numpy

    return params_to_numpy(MultiLayerNetwork(conf, device="cpu").init())


def mnist_leaf_shapes(conf):
    return [p[k].shape for p in conf_host(conf) for k in sorted(p)]


def wrong_adam(net, fault):
    """Make ``net``'s Adam wrong by ``fault`` (one of RECIPE_FAULTS; None
    leaves it right) and return what undoes the part shared by every net."""
    from deeplearning4j_tpu_torch.nn import updaters

    updater = net._updater_ready()
    real_bc = updaters.bias_corrections
    if fault == "adam_b1_b2_swapped":
        b1, b2, eps = updater.adam
        updater.adam = (b2, b1, eps)
    elif fault == "no_bias_correction":
        updaters.bias_corrections = lambda *a: (1.0, 1.0)

    def undo():
        updaters.bias_corrections = real_bc

    return undo


def phase_train_mnist(torch, name, card):
    """``name``'s Adam training from its seed params over MNIST_UPDATES
    batches of MnistDataSetIterator (shuffled by its seed): the card
    against the CPU by ``recipe_readings``, exactly one softmax-xent
    forward and backward and one Adam launch per update, each of
    RECIPE_FAULTS caught; then ms per update, median of 5 after 2
    warm-ups, at the model's batch. Returns (launch counts, ms per
    update)."""
    import numpy as np

    from deeplearning4j_tpu_torch import (MnistDataSetIterator, MultiLayerNetwork,
                                          load_jax_params, ops, params_to_numpy)

    B, conf = mnist_models()[name]
    shape = (-1, 28, 28, 1) if name == "lenet" else (-1, 784)
    batches = [(ds.features.reshape(shape), ds.labels)
               for ds in MnistDataSetIterator(batch=B, num_examples=B * MNIST_UPDATES)]
    host = conf_host(conf)

    def train(dev, fault=None):
        net = load_jax_params(MultiLayerNetwork(conf, device=dev), host)
        rec = LossRecorder()
        net.set_listeners(rec)
        undo = wrong_adam(net, fault)
        try:
            if dev == "cuda":
                torch.cuda.synchronize()
                ops.reset_counters()
            for b in batches:
                net.fit(b)
            if dev == "cuda":
                torch.cuda.synchronize()
            launches = ops.counters() if dev == "cuda" else None
        finally:
            undo()
        net.set_listeners()
        return (net, np.array([float(l) for l in rec.losses]), params_to_numpy(net)), launches

    card_run, launches = train("cuda")
    cpu_run, _ = train("cpu")
    readings = recipe_readings(card_run, cpu_run, host, lr=1e-3)
    within = within_limits(readings, MNIST_LIMITS)
    faults = {}
    for fault in RECIPE_FAULTS:
        faults[fault] = recipe_readings(train("cuda", fault)[0], cpu_run, host, lr=1e-3)
        faults[fault]["caught"] = not within_limits(faults[fault], MNIST_LIMITS)
    net = card_run[0]
    expected = dict.fromkeys(launches, 0)
    expected.update({"softmax_xent_fwd": MNIST_UPDATES, "softmax_xent_bwd": MNIST_UPDATES,
                     "adam_update": MNIST_UPDATES * adam_launches(net)})
    times, timed_launches, losses = timed_fit(torch, net, batches[0], **MNIST_TIMED)
    timed_expected = {k: v // MNIST_UPDATES * MNIST_TIMED["timed"] for k, v in expected.items()}
    ms = statistics.median(times)
    ok = (within and all(f["caught"] for f in faults.values()) and launches == expected
          and timed_launches == timed_expected and bool(np.isfinite(losses).all())
          and bool(cpu_run[1][-1] < cpu_run[1][0]))
    emit(f"train_{'lenet' if name == 'lenet' else 'mlp_mnist'}", B=B, updates=MNIST_UPDATES,
         card_losses=card_run[1].tolist(), cpu_losses=cpu_run[1].tolist(),
         readings_vs_cpu=readings, limits=MNIST_LIMITS, faults_vs_cpu=faults,
         kernel_launches=launches, expected_launches=expected,
         timed_launches=timed_launches, update_ms_runs=times, ms_per_update=ms,
         images_per_s=B / (ms / 1e3), ok=ok, gpu=card)
    if not ok:
        raise AssertionError(f"{name} training failed its checks")
    return {k: launches.get(k, 0) + timed_launches.get(k, 0)
            for k in set(launches) | set(timed_launches)}, ms


# ---- slice 16: the JAX package's accuracy pins on real data
# (tests/test_accuracy_parity.py) trained on the card through the datasets
# tier: LeNet on the bundled handwritten digits and an MLP on Iris from
# JAX's initial params (REAL_DATA_INIT, written by
# scripts/make_real_data_init.py), the char-RNN on the pangram text from the
# port's own init at the pin's seed; then the char-RNN at full width fed
# from sequence record files (masks from SequenceRecordReaderDataSetIterator)
REAL_DATA_INIT = os.path.join("tests", "data", "jax_init_real_data.npz")
PIN_ACCURACY = 0.95  # digits held out (360), Iris the full set (150)
REAL_DATA_EPOCHS = {"digits": 18, "iris": 200}
REAL_DATA_COMPARED = 3  # updates of each pin held against the CPU port
PANGRAM_TEXT = ("the quick brown fox jumps over the lazy dog. "
                "pack my box with five dozen liquor jugs. "
                "how vexingly quick daft zebras jump! ") * 8
PANGRAM_BPC = 1.8  # bits per char of score() on the first batch
PANGRAM_H, PANGRAM_TBPTT, PANGRAM_T, PANGRAM_B, PANGRAM_EPOCHS = 96, 32, 64, 8, 60
# train_records: RECORDS_SEQS sequences of the pangram text, lengths drawn in
# 64..256, one CSV file each, batches of RECORDS_B
RECORDS_SEQS, RECORDS_B = 16, 8


def real_data_models():
    """name -> (batch, conf) of the two real-data pins, in the JAX package's
    call form (an UpdaterConfig): tests/test_accuracy_parity.py's confs."""
    from deeplearning4j_tpu_torch import (ConvolutionLayer, DenseLayer, InputType,
                                          MultiLayerConfiguration, OutputLayer,
                                          SubsamplingLayer, UpdaterConfig)

    digits = MultiLayerConfiguration(
        layers=[ConvolutionLayer(n_out=20, kernel=(3, 3), activation="identity"),
                SubsamplingLayer(pooling_type="max", kernel=(2, 2), stride=(2, 2)),
                ConvolutionLayer(n_out=50, kernel=(2, 2), activation="identity"),
                SubsamplingLayer(pooling_type="max", kernel=(2, 2), stride=(2, 2)),
                DenseLayer(n_out=128, activation="relu"),
                OutputLayer(n_out=10, activation="softmax", loss="mcxent")],
        input_type=InputType.convolutional(8, 8, 1),
        updater=UpdaterConfig(updater="adam", learning_rate=2e-3), seed=5)
    iris = MultiLayerConfiguration(
        layers=[DenseLayer(n_out=16, activation="tanh"),
                OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        input_type=InputType.feed_forward(4),
        updater=UpdaterConfig(updater="adam", learning_rate=5e-3), seed=6)
    return {"digits": (128, digits), "iris": (50, iris)}


def real_data_host(name):
    """JAX's initial params of the pin ``name`` from REAL_DATA_INIT, one dict
    of f32 arrays per layer (the layout load_jax_params takes)."""
    import numpy as np

    layers: dict = {}
    with np.load(os.path.join(HERE, REAL_DATA_INIT)) as z:
        for key in z.files:
            model, i, k = key.split("/")
            if model == name:
                layers.setdefault(int(i), {})[k] = z[key]
    return [layers.get(i, {}) for i in range(max(layers) + 1)]  # pooling layers: {}


def real_data_iterators(name):
    """(training iterator, evaluation iterator) of the pin, as JAX's test
    makes them: digits shuffled by seed 123, the 360 held out in order;
    Iris in batches of 50, evaluated at once."""
    from deeplearning4j_tpu_torch import DigitsDataSetIterator, IrisDataSetIterator

    if name == "digits":
        return (DigitsDataSetIterator(batch=128, train=True),
                DigitsDataSetIterator(batch=120, train=False, shuffle=False))
    return IrisDataSetIterator(batch=50), IrisDataSetIterator(batch=150, shuffle=False)


def phase_kernels_real_data(torch, sx):
    """Rows 10-11 against their plain versions at slice 16's loss heads
    (REAL_DATA_SXENT; f32). Returns the errors by phase."""
    return {name: sxent_case(torch, sx, N, C, "float32", "one_hot", SEED + N)
            for name, (N, C) in REAL_DATA_SXENT.items()}


class AsItComes:
    """An iterator read as it comes: its batches and resets without
    ``prefetch_supported``, so ``fit`` copies each batch to the card as its
    update takes it (the path before ``fit`` prefetched)."""

    def __init__(self, base):
        self.base = base

    def reset(self):
        self.base.reset()

    def __iter__(self):
        return iter(self.base)


def phase_train_real(torch, name, card):
    """The pin ``name`` on the card from JAX's initial params: its epochs of
    ``fit`` over its iterator (reset each epoch), then ``evaluate``; exactly
    one softmax-xent forward and backward and one Adam launch per update in
    that run; its accuracy at PIN_ACCURACY. Its first REAL_DATA_COMPARED
    updates (the first batches of epoch 0) are held against the CPU port's
    from the same weights by ``recipe_readings`` at MNIST_LIMITS (rows
    10-12's f32 limits), and each of RECIPE_FAULTS on the card must fail
    them (Adam's first step is lr * g/|g| whatever b1 and b2 are, so a swap
    of the two shows from the second update on). Then the same epochs from
    the same weights, timed in turns through ``fit``'s reader (one
    DevicePrefetchIterator a call, which hands batches under
    PREFETCH_MIN_BYTES out as they come) and as they come; and staged
    (``stage_on_device`` STAGED_K, after one epoch that captures the step),
    twice. Returns (launch counts, the card's net, the accuracy)."""
    import numpy as np

    from deeplearning4j_tpu_torch import MultiLayerNetwork, load_jax_params, ops, params_to_numpy

    _, conf = real_data_models()[name]
    host = real_data_host(name)
    lr = conf.updater["learning_rate"]
    first = list(itertools.islice(real_data_iterators(name)[0], REAL_DATA_COMPARED))

    def first_updates(dev, fault=None):
        net = load_jax_params(MultiLayerNetwork(conf, device=dev), host)
        rec = LossRecorder()
        net.set_listeners(rec)
        undo = wrong_adam(net, fault)
        try:
            for ds in first:
                net.fit(ds)
        finally:
            undo()
        return net, np.array([float(l) for l in rec.losses]), params_to_numpy(net)

    cpu = first_updates("cpu")
    readings = recipe_readings(first_updates("cuda"), cpu, host, lr=lr)
    faults = {}
    for fault in RECIPE_FAULTS:
        faults[fault] = recipe_readings(first_updates("cuda", fault), cpu, host, lr=lr)
        faults[fault]["caught"] = not within_limits(faults[fault], MNIST_LIMITS)

    train_it, eval_it = real_data_iterators(name)
    net = load_jax_params(MultiLayerNetwork(conf), host)
    rec = LossRecorder()
    net.set_listeners(rec)
    torch.cuda.synchronize()
    ops.reset_counters()
    t0 = time.perf_counter()
    net.fit(train_it, epochs=REAL_DATA_EPOCHS[name])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    ev = net.evaluate(eval_it)
    launches = ops.counters()
    net.set_listeners()
    losses = np.array([float(l) for l in rec.losses])
    updates = REAL_DATA_EPOCHS[name] * len(train_it)
    expected = dict.fromkeys(launches, 0)
    expected.update({"softmax_xent_fwd": updates, "softmax_xent_bwd": updates,
                     "adam_update": updates * adam_launches(net)})
    acc = ev.accuracy()

    def epochs_ms(how):
        run = load_jax_params(MultiLayerNetwork(conf), host)
        it = real_data_iterators(name)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.fit(it if how == "read_ahead" else AsItComes(it), epochs=REAL_DATA_EPOCHS[name])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / updates

    fit_ms = {"read_ahead": [], "as_it_comes": []}
    for how in ("as_it_comes", "read_ahead", "read_ahead", "as_it_comes"):
        fit_ms[how].append(epochs_ms(how))
    staged = load_jax_params(MultiLayerNetwork(conf), host)
    staged.fit(real_data_iterators(name)[0], stage_on_device=STAGED_K)  # the capture
    staged_ms = []
    for _ in range(2):
        it = real_data_iterators(name)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        staged.fit(it, epochs=REAL_DATA_EPOCHS[name], stage_on_device=STAGED_K)
        torch.cuda.synchronize()
        staged_ms.append((time.perf_counter() - t0) * 1e3 / updates)
    staged_replays = staged._step_graphs.replays
    del staged
    ok = (acc >= PIN_ACCURACY and launches == expected and len(losses) == updates
          and bool(np.isfinite(losses).all()) and within_limits(readings, MNIST_LIMITS)
          and all(f["caught"] for f in faults.values())
          and staged_replays == updates * 2 + len(train_it))
    emit(f"train_{name}", epochs=REAL_DATA_EPOCHS[name], B=real_data_models()[name][0],
         updates=updates, accuracy=acc, pin=PIN_ACCURACY, examples=ev.examples,
         first_loss=float(losses[0]), last_loss=float(losses[-1]),
         first_updates_vs_cpu=readings, compared_updates=REAL_DATA_COMPARED,
         limits=MNIST_LIMITS, faults_vs_cpu=faults,
         kernel_launches=launches, expected_launches=expected, fit_seconds=fit_s,
         ms_per_update=fit_s * 1e3 / updates, ms_per_update_runs=fit_ms,
         read_ahead_ms_per_update=min(fit_ms["read_ahead"]),
         as_it_comes_ms_per_update=min(fit_ms["as_it_comes"]),
         staged_ms_per_update_runs=staged_ms, staged_replays=staged_replays,
         staged_ms_per_update=min(staged_ms), ok=ok, gpu=card)
    if not ok:
        raise AssertionError(f"train_{name} failed its checks")
    return launches, net, acc


def pangram_conf():
    """The pangram pin's char-RNN (tests/test_accuracy_parity.py)."""
    from deeplearning4j_tpu_torch import char_rnn

    return char_rnn(vocab_size=len(set(PANGRAM_TEXT)), hidden_size=PANGRAM_H, num_layers=2,
                    tbptt_length=PANGRAM_TBPTT, learning_rate=3e-3, seed=5)


def pangram_batches():
    """(xs, ys): the pangram text as next-char one-hot sequences of
    PANGRAM_T steps [n, T, 29], cut as JAX's test cuts them."""
    import numpy as np

    vocab = sorted(set(PANGRAM_TEXT))
    ids = np.array([vocab.index(c) for c in PANGRAM_TEXT])
    n = (len(ids) - 1) // PANGRAM_T
    eye = np.eye(len(vocab), dtype=np.float32)
    t = PANGRAM_T
    return (np.stack([eye[ids[i * t:(i + 1) * t]] for i in range(n)]),
            np.stack([eye[ids[i * t + 1:(i + 1) * t + 1]] for i in range(n)]))


def lstm_rows_at(torch, ls, T, B, H, card, where, mask=None, gate="sigmoid", faults=False):
    """The training kernels of one LSTM layer at [T, B, H], f32, with the
    gate activation ``gate``: rows 6-7 (8-9 with ``mask``, [T, B, 1])
    against their plain versions on the same CUDA tensors (every output;
    dRW and the peephole grads over their largest element; with
    ``faults``, row 7's wrong products caught) and the dRW product alone at
    R = T*B; then each timed beside its plain version and its bound, dRW
    also beside torch.matmul(hp.t(), dz). Returns {name: (max abs err,
    times)}."""
    import numpy as np

    dt, lim = torch.float32, KERNEL_ATOL["float32"]
    fwd, bwd = (("lstm_seq_masked_train_fwd", "lstm_seq_masked_bwd") if mask is not None
                else ("lstm_seq_train_fwd", "lstm_seq_bwd"))
    acts = ("tanh", gate)
    at = dict(at=where, gate=gate)
    args = seq_inputs(torch, T, B, H, "float32", False, SEED + T + H)
    got = ls.lstm_sequence_masked_train_forward(args[0], mask, *args[1:], *acts)
    want = ls.lstm_sequence_masked_train_reference(args[0], mask, *args[1:], *acts)
    names = ("ys", "a", "f", "o", "i", "c", "hT", "cT")
    torch.cuda.synchronize()
    e = {n: float((g.float() - w.float()).abs().max()) for n, g, w in zip(names, got, want)}
    out = {fwd: [check(fwd, "float32", e, dict.fromkeys(e, lim), T=T, B=B, H=H, **at)]}
    rng = np.random.default_rng(SEED + T)
    up = [torch.as_tensor(rng.normal(0.0, 0.1, shape), dtype=dt, device=DEVICE)
          for shape in ((T, B, H), (B, H), (B, H))]
    res = tuple(want[:6]) + tuple(args[1:])
    got = ls.lstm_sequence_masked_backward(*up, mask, *res, *acts)
    ref = ls.lstm_sequence_masked_backward_reference(*up, mask, *res, *acts)
    torch.cuda.synchronize()
    e = f32_bwd_readings(got, ref)
    check(bwd, "float32", e, dict.fromkeys(e, lim), T=T, B=B, H=H, **at,
          summed_grads_relative_to_largest=list(SUMMED_GRADS))
    if faults:
        bwd_faults_caught(ls, "float32", T, up, res, ref, gate=gate, B=B, H=H)
    out[bwd] = [max_abs(got, ref)]
    h0, ys, dzx = args[1], want[0], torch.as_tensor(rng.normal(0.0, 1e-2, (T, B, 4 * H)),
                                                    dtype=dt, device=DEVICE)
    got, ref = ls.drw_product(h0, ys, dzx), ls.drw_product_reference(h0, ys, dzx)
    torch.cuda.synchronize()
    r = rel_readings([got], [ref], ["dRW"])["dRW"]
    ok = tuple(got.shape) == (H, 4 * H) and drw_within(r, "float32")
    emit("kernel_vs_plain", kernel="drw_product", dtype="float32", T=T, B=B, R=T * B, H=H,
         at=where, readings=r, limit=KERNEL_ATOL["float32"], ok=ok)
    if not ok:
        raise AssertionError(f"drw_product at {where}: {r} outside the limit")
    out["drw_product"] = [r["max_abs"]]
    hp = torch.cat([h0[None], ys[:T - 1]]).reshape(-1, H).contiguous()
    dz = dzx.reshape(-1, 4 * H).contiguous()
    live = 1.0 if mask is None else live_share(mask)
    for name, kern, plain, lib, b in (
            (fwd, lambda: ls.lstm_sequence_masked_train_forward(args[0], mask, *args[1:], *acts),
             lambda: ls.lstm_sequence_masked_train_reference(args[0], mask, *args[1:], *acts),
             None, bound_train_fwd(T, B, H, "float32", masked=mask is not None)),
            (bwd, lambda: ls.lstm_sequence_masked_backward(*up, mask, *res, *acts),
             lambda: ls.lstm_sequence_masked_backward_reference(*up, mask, *res, *acts), None,
             bound_bwd(T, B, H, "float32", live=live, masked=mask is not None)),
            ("drw_product", lambda: ls.drw_product(h0, ys, dzx),
             lambda: ls.drw_product_reference(h0, ys, dzx), lambda: torch.matmul(hp.t(), dz),
             bound_drw(T * B, H, "float32"))):
        out[name].append(time_pair(torch, name, kern, plain, lib, *b, card, dtype="float32",
                                   T=T, B=B, H=H, **at, mask_live_share=live))
    return out


def phase_train_pangram(torch, ls, card):
    """The pangram pin on the card from the port's own init at seed 5 (drawn
    on the CPU): PANGRAM_EPOCHS epochs of TBPTT(32) Adam over the batches of
    JAX's test, then ``score`` on the first batch in bits per char, held at
    PANGRAM_BPC; the launches of that run exactly (rows 6-7 and dRW per
    layer and update, 10-12 per update; ``score``'s forward: row 5 per
    layer, row 10 once). Returns (launch counts, bits per char)."""
    import math

    import numpy as np

    from deeplearning4j_tpu_torch import (DataSet, MultiLayerNetwork, load_jax_params, ops,
                                          params_to_numpy)

    conf = pangram_conf()
    host = params_to_numpy(MultiLayerNetwork(conf, device="cpu").init())
    xs, ys = pangram_batches()
    b = PANGRAM_B
    starts = range(0, len(xs) - b + 1, b)
    net = load_jax_params(MultiLayerNetwork(conf), host)
    rec = LossRecorder()
    net.set_listeners(rec)
    torch.cuda.synchronize()
    ops.reset_counters()
    t0 = time.perf_counter()
    for _ in range(PANGRAM_EPOCHS):
        for s in starts:
            net.fit(DataSet(xs[s:s + b], ys[s:s + b]))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    bpc = net.score(DataSet(xs[:b], ys[:b])) / math.log(2)
    torch.cuda.synchronize()
    launches = ops.counters()
    net.set_listeners()
    losses = np.array([float(l) for l in rec.losses])
    updates = PANGRAM_EPOCHS * len(starts) * -(-PANGRAM_T // PANGRAM_TBPTT)
    layers = len(conf.layers) - 1
    expected = dict.fromkeys(launches, 0)
    expected.update({"lstm_seq_train_fwd": layers * updates, "lstm_seq_bwd": layers * updates,
                     "drw_product": layers * updates, "softmax_xent_fwd": updates + 1,
                     "softmax_xent_bwd": updates, "lstm_seq_lean": layers,
                     "adam_update": updates * adam_launches(net)})
    ok = (bpc <= PANGRAM_BPC and launches == expected and len(losses) == updates
          and bool(np.isfinite(losses).all()))
    emit("train_pangram", epochs=PANGRAM_EPOCHS, B=b, T=PANGRAM_T, H=PANGRAM_H,
         tbptt=PANGRAM_TBPTT, updates=updates, bits_per_char=bpc, pin=PANGRAM_BPC,
         first_loss=float(losses[0]), last_loss=float(losses[-1]), kernel_launches=launches,
         expected_launches=expected, fit_seconds=fit_s, ms_per_update=fit_s * 1e3 / updates,
         ok=ok, gpu=card)
    if not ok:
        raise AssertionError("train_pangram failed its checks")
    return launches, bpc


def records_text(tmp: str):
    """RECORDS_SEQS next-char sequences of the pangram text, lengths drawn
    from the seed in 64..256, each from a random place in it, written as one
    CSV file each under ``tmp`` (a row: the 29 one-hot columns of a char and
    the next char's index). Returns the lengths."""
    import numpy as np

    vocab = sorted(set(PANGRAM_TEXT))
    ids = np.array([vocab.index(c) for c in PANGRAM_TEXT * 2])
    rng = np.random.default_rng(SEED + 16)
    lengths = rng.integers(64, 257, RECORDS_SEQS)
    eye = np.eye(len(vocab), dtype=np.int64)
    for k, n in enumerate(lengths):
        s = int(rng.integers(0, len(PANGRAM_TEXT)))
        rows = np.concatenate([eye[ids[s:s + n]], ids[s + 1:s + n + 1, None]], axis=1)
        np.savetxt(os.path.join(tmp, f"seq_{k:03d}.csv"), rows, fmt="%d", delimiter=",")
    return lengths.tolist()


def iris_split(tmp: str) -> str:
    """The bundled Iris rows in an order drawn from the seed, with the
    header, as ``tmp``/iris_split.csv."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets import fetchers

    with open(os.path.join(fetchers.DATA_DIR, "iris.csv")) as f:
        header, *rows = f.read().splitlines()
    order = np.random.default_rng(SEED + 17).permutation(len(rows))
    path = os.path.join(tmp, "iris_split.csv")
    with open(path, "w") as f:
        f.write("\n".join([header] + [rows[i] for i in order]) + "\n")
    return path


def phase_train_records(torch, iris_net, iris_acc, card):
    """The char-RNN at the smoke's width (H=512, 2 layers, vocab 29) fed
    from sequence record files (``records_text``) through
    CSVSequenceRecordReader and SequenceRecordReaderDataSetIterator
    (ALIGN_START, label column 29), padded batches with masks, so through
    rows 8-9: one epoch of the recipe (Adam, TBPTT(50)) on the card from
    numpy-drawn weights, its launches exactly; its first batch's updates
    against the CPU port's from the same weights by ``recipe_readings`` at
    RECIPE_LIMITS. Then ``evaluate`` of the Iris pin's net over a CSV split
    of Iris through RecordReaderDataSetIterator with ``collect_metadata``:
    each misclassified record named by its file and line, reloaded from it,
    and the accuracy that of train_iris. Returns (launch counts, the first
    batch's mask as [T, B, 1] of its first TBPTT segment)."""
    import tempfile

    import numpy as np

    from deeplearning4j_tpu_torch import (MultiLayerNetwork, char_rnn, load_jax_params, ops,
                                          params_to_numpy)
    from deeplearning4j_tpu_torch.datasets import (ALIGN_START, CSVRecordReader,
                                                   CSVSequenceRecordReader,
                                                   RecordReaderDataSetIterator,
                                                   SequenceRecordReaderDataSetIterator)

    vocab = len(set(PANGRAM_TEXT))
    conf = char_rnn(vocab, HIDDEN, LAYERS)
    host = char_rnn_params(conf, SEED)
    with tempfile.TemporaryDirectory() as tmp:
        lengths = records_text(tmp)

        def batches():
            return SequenceRecordReaderDataSetIterator(
                CSVSequenceRecordReader(tmp), RECORDS_B, label_index=vocab, num_classes=vocab,
                alignment=ALIGN_START)

        it = batches()
        listed = list(batches())
        masked = all(ds.features_mask is not None and ds.labels_mask is not None
                     for ds in listed)
        first = listed[0]

        def run(dev, data):
            net = load_jax_params(MultiLayerNetwork(conf, device=dev), host)
            rec = LossRecorder()
            net.set_listeners(rec)
            net.fit(data)
            return net, np.array([float(l) for l in rec.losses]), params_to_numpy(net)

        readings = recipe_readings(run("cuda", first), run("cpu", first), host)
        net = load_jax_params(MultiLayerNetwork(conf), host)
        rec = LossRecorder()
        net.set_listeners(rec)
        torch.cuda.synchronize()
        ops.reset_counters()
        t0 = time.perf_counter()
        net.fit(it)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = ops.counters()
        net.set_listeners()
        losses = np.array([float(l) for l in rec.losses])
        updates = sum(-(-ds.features.shape[1] // conf.tbptt_fwd_length) for ds in listed)
        expected = dict.fromkeys(launches, 0)
        expected.update({"lstm_seq_masked_train_fwd": LAYERS * updates,
                         "lstm_seq_masked_bwd": LAYERS * updates,
                         "drw_product": LAYERS * updates, "softmax_xent_fwd": updates,
                         "softmax_xent_bwd": updates,
                         "adam_update": updates * adam_launches(net)})

        path = iris_split(tmp)
        ev = iris_net.evaluate(RecordReaderDataSetIterator(
            CSVRecordReader(path, skip_lines=1), 50, label_index=4, num_classes=3,
            collect_metadata=True))
        with open(path) as f:
            lines = f.read().splitlines()
        named, reloaded = [], True
        for p in ev.prediction_errors():
            m = p.record_metadata
            line = m.index + 2  # 1-based, after the header
            named.append(f"{os.path.basename(m.source)}:{line} actual {p.actual_class} "
                         f"predicted {p.predicted_class}")
            want = [float(v) for v in lines[line - 1].split(",")]
            reloaded &= (m.source == path and p.get_record() == want
                         and int(want[-1]) == p.actual_class)
    meta_ok = (len(ev.predictions) == 150 and reloaded and abs(ev.accuracy() - iris_acc) < 1e-12
               and len(named) == round((1 - ev.accuracy()) * 150))
    ok = (masked and launches == expected and len(losses) == updates
          and bool(np.isfinite(losses).all())
          and within_limits(readings, RECIPE_LIMITS["float32"]) and meta_ok)
    emit("train_records", sequences=RECORDS_SEQS, lengths=lengths, B=RECORDS_B,
         padded_T=[int(ds.features.shape[1]) for ds in listed], H=HIDDEN, layers=LAYERS,
         masks_from_iterator=masked, updates=updates, first_loss=float(losses[0]),
         last_loss=float(losses[-1]), first_batch_vs_cpu=readings,
         limits=RECIPE_LIMITS["float32"], kernel_launches=launches,
         expected_launches=expected, fit_seconds=fit_s, iris_records_accuracy=ev.accuracy(),
         iris_array_accuracy=iris_acc, misclassified_records=named, metadata_ok=meta_ok,
         ok=ok, gpu=card)
    if not ok:
        raise AssertionError("train_records failed its checks")
    m, seg = first.features_mask, conf.tbptt_fwd_length
    t0 = min(range(0, m.shape[1], seg), key=lambda t: float(m[:, t:t + seg].mean()))
    mask = np.ascontiguousarray(m[:, t0:t0 + seg].T[..., None])
    return launches, torch.as_tensor(mask, device=DEVICE)


def lean_at(torch, ls, T, B, H, card, where, gate="sigmoid", live=None, faults=False):
    """Row 5 at [T, B, H], f32, with the gate activation ``gate`` (masked
    where ``live`` steps of T are, as a served bucket pads time), against
    its plain version (with ``faults``, its wrong products caught), then
    timed beside it and its bound. Returns (max abs err, times)."""
    args = seq_inputs(torch, T, B, H, "float32", False, SEED + T) + ["tanh", gate]
    at = dict(at=where, gate=gate)
    name, kern, plain = "lstm_seq_lean", ls.fused_lstm_sequence, ls.lstm_sequence_reference
    if live is not None:
        mask = torch.zeros(T, B, 1, device=DEVICE)
        mask[:live] = 1.0
        args.insert(1, mask)
        at["live_steps"] = live
        name = "lstm_seq_lean_masked"
        kern, plain = ls.fused_lstm_sequence_masked, ls.lstm_sequence_masked_reference
    got, want = kern(*args), plain(*args)
    torch.cuda.synchronize()
    e = {n: float((g - w).abs().max()) for n, g, w in zip(("ys", "hT", "cT"), got, want)}
    err = check(name, "float32", e, dict.fromkeys(e, KERNEL_ATOL["float32"]),
                T=T, B=B, H=H, **at)
    if faults:
        zx, mask, rest = (args[0], args[1], args[2:-2]) if live is not None else (
            args[0], None, args[1:-2])
        fwd_faults_caught(
            name, "float32", lambda product: ls.lstm_sequence_masked_reference(
                zx, mask, *rest, "tanh", gate, product),
            want, lambda got, ref: ({"max_abs_err": max_abs(got, ref)},
                                    max_abs(got, ref) <= KERNEL_ATOL["float32"]),
            dict(T=T, B=B, H=H, limit=KERNEL_ATOL["float32"], **at))
    return err, time_pair(torch, name, lambda: kern(*args), lambda: plain(*args), None,
                          *bound(T, B, H, "float32", live is not None,
                                 1.0 if live is None else live_share(args[1])),
                          card, dtype="float32",
                          T=T, B=B, H=H, **at)


def real_data_adam_shapes():
    """Param leaf shapes of slice 16's nets, by phase."""
    import numpy as np

    from deeplearning4j_tpu_torch import MultiLayerNetwork, char_rnn, params_to_numpy

    pangram = params_to_numpy(MultiLayerNetwork(pangram_conf(), device="cpu").init())
    records = char_rnn_params(char_rnn(len(set(PANGRAM_TEXT)), HIDDEN, LAYERS), SEED)
    hosts = {"digits": real_data_host("digits"), "iris": real_data_host("iris"),
             "pangram": pangram, "records": records}
    return {name: [np.shape(p[k]) for p in host for k in sorted(p)]
            for name, host in hosts.items()}


# the kernels each of slice 16's phases must launch, and the kernels line
# reads at its shapes
REAL_DATA_ROWS = {
    "digits": ("softmax_xent_fwd", "softmax_xent_bwd", "adam_update"),
    "iris": ("softmax_xent_fwd", "softmax_xent_bwd", "adam_update"),
    "pangram": ("lstm_seq_lean", "lstm_seq_train_fwd", "lstm_seq_bwd", "drw_product",
                "softmax_xent_fwd", "softmax_xent_bwd", "adam_update"),
    "records": ("lstm_seq_masked_train_fwd", "lstm_seq_masked_bwd", "drw_product",
                "softmax_xent_fwd", "softmax_xent_bwd", "adam_update"),
}
# slice 16's loss heads, by phase: [N, C] of rows 10-11 (pangram: B * TBPTT
# rows; records: B * 50, a full TBPTT segment)
REAL_DATA_SXENT = {"digits": (128, 10), "iris": (50, 3),
                   "pangram": (PANGRAM_B * PANGRAM_TBPTT, 29), "records": (RECORDS_B * 50, 29)}


def time_sxent_head(torch, sx, card):
    """ms of rows 10-11 at the image nets' loss head (N=128 rows, C=1000
    classes), f32 and bf16."""
    return time_sxent(torch, sx, *ALEX_SXENT, ("float32", "bfloat16"), card,
                      "image nets' loss head (AlexNet, GoogLeNet, ResNet-50)")


def time_sxent(torch, sx, N, C, dtypes, card, layer):
    """ms of rows 10-11 at [N, C] in each of ``dtypes``, beside the plain
    versions, the bounds and cross_entropy with probability targets
    (forward; forward+backward), by (kernel, dtype)."""
    import numpy as np
    import torch.nn.functional as F

    times = {}
    for dtype in dtypes:
        x, lab = sxent_inputs(torch, N, dtype, "one_hot", SEED, C=C)
        g = torch.as_tensor(np.random.default_rng(SEED).normal(0.0, 1.0, N),
                            dtype=torch.float32, device=DEVICE)
        xg, lg = x.clone().requires_grad_(), lab.clone().requires_grad_()
        gl = g.to(x.dtype)

        def lib_fwd_bwd():
            xg.grad = lg.grad = None
            F.cross_entropy(xg, lg, reduction="none").backward(gl)

        for name, kern, plain, lib, backward in (
                ("softmax_xent_fwd", lambda: sx.fused_softmax_xent(x, lab),
                 lambda: sx.softmax_xent_reference(x, lab),
                 lambda: F.cross_entropy(x, lab, reduction="none"), False),
                ("softmax_xent_bwd", lambda: sx.softmax_xent_backward(x, lab, g),
                 lambda: sx.softmax_xent_backward_reference(x, lab, g), lib_fwd_bwd, True)):
            times[(name, dtype)] = time_pair(
                torch, name, kern, plain, lib, *bound_sxent(N, C, dtype, backward), card,
                dtype=dtype, N=N, C=C, layer=layer, ms_in_a_row=in_a_row_ms(kern))
    return times


def lrn_entry(dtype: str, backward: bool, with_d: bool = True) -> str:
    """The readable name of the entry that AlexNet's LRN launches (n=5,
    beta 0.75, contiguous: windows in registers)."""
    t, v = ("float", 4) if dtype == "float32" else ("__nv_bfloat16", 8)
    if backward:
        return f"lrn_bwd<{t}, (int){v}, (int)5>"
    return f"lrn_fwd<{t}, (bool){int(with_d)}, (int){v}, (int)5>"


def static_issue_ms(torch, lr, sass: dict, entry: str, elems: int) -> dict:
    """The time the card would take to issue an LRN entry's tile loop over
    ``elems`` elements if every instruction of the loop ran: its SASS
    instructions (``sass_counts``: the code a thread holds for its
    TILE_ELEMS elements of a tile) once per warp of every tile, at one warp
    instruction a clock on each of an SM's 4 schedulers, at the card's top
    SM clock. The count is static: it holds powf's special-case blocks (a
    zero, NaN, infinite or subnormal d), which no element here runs, so the
    time is an upper estimate of what is issued, not a floor."""
    loop = next(f["loop_instructions"] for name, f in sass.items() if entry in name)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    warps = elems / lr.TILE_ELEMS / 32
    return {"static_issue_ms": warps * loop / (4 * sms * mhz * 1e6) * 1e3,
            "loop_instructions": loop, "instructions_per_element": loop / lr.TILE_ELEMS,
            "sm_clock_max_mhz": mhz, "sms": sms}


def in_a_row_ms(fn, calls: int = 20) -> float:
    """ms a call of ``fn`` over ``calls`` calls in a row (median of 7): the
    card's time, which the host's part of each call no longer delays."""
    return median_ms(lambda: [fn() for _ in range(calls)]) / calls


def time_lrn(torch, lr, card, sass: dict):
    """ms of rows 3-4 at AlexNet's LRN 1 shape (the table's) and LRN 2's,
    and at GoogLeNet's two, f32 and bf16, beside the plain versions, the bounds and F.local_response_norm on
    the same channels-last view (torch divides alpha by n: it is given
    alpha*n): its forward for row 3, its forward plus backward for row 4.
    The serving forward (y alone) is timed beside the training one, and
    each also over 20 calls in a row (``ms_in_a_row``). Each line also
    gives the time to issue the entry's tile loop as its SASS holds it
    (``static_issue_ms``, from ``sass``: the lrn library's entries of
    phase_sass), an upper estimate of what is issued."""
    import math

    import torch.nn.functional as F

    times = {}
    args = (LRN_K, LRN_N, LRN_ALPHA, LRN_BETA)
    for dtype in ("float32", "bfloat16"):
        for where, shape in {**LRN_SHAPES, **GOOG_LRN_SHAPES}.items():
            x, g = lrn_inputs(torch, shape, dtype, SEED)
            _, d = lr.lrn_forward(x, *args)
            xg = x.clone().requires_grad_()
            elems = math.prod(shape)

            def lib_fwd(x=x):
                return F.local_response_norm(x.permute(0, 3, 1, 2), LRN_N,
                                             alpha=LRN_ALPHA * LRN_N, beta=LRN_BETA, k=LRN_K)

            def lib_fwd_bwd(xg=xg, g=g):
                xg.grad = None
                lib_fwd(xg).backward(g.permute(0, 3, 1, 2))

            serving_ms = min(median_ms(lambda: lr.lrn_forward(x, *args, with_d=False))
                             for _ in range(2))
            cases = (
                ("lrn_fwd", lambda: lr.lrn_forward(x, *args), lambda: lr.lrn_reference(x, *args),
                 lib_fwd, bound_lrn(shape, dtype, False)),
                ("lrn_bwd", lambda: lr.lrn_backward(x, d, g, *args),
                 lambda: lr.lrn_backward_reference(x, d, g, *args), lib_fwd_bwd,
                 bound_lrn(shape, dtype, True)),
            )
            for name, kern, plain, lib, (b_ms, b_by) in cases:
                backward = name == "lrn_bwd"
                extra = static_issue_ms(torch, lr, sass, lrn_entry(dtype, backward), elems)
                extra["ms_in_a_row"] = in_a_row_ms(kern)
                if not backward:
                    extra.update(serving_ms=serving_ms,
                                 serving_ms_in_a_row=in_a_row_ms(
                                     lambda: lr.lrn_forward(x, *args, with_d=False)),
                                 serving_bound_ms=bound_lrn(shape, dtype, False, False)[0],
                                 serving_static_issue_ms=static_issue_ms(
                                     torch, lr, sass, lrn_entry(dtype, False, False),
                                     elems)["static_issue_ms"])
                t = time_pair(torch, name, kern, plain, lib, b_ms, b_by, card, dtype=dtype,
                              layer=where, shape=list(shape), n=LRN_N, **extra)
                times[(name, dtype, where)] = t
    return times


# kernels whose products must run on the tensor cores (rows 13-15; the LSTM
# forward step of rows 1, 5, 6 and 8; rows 7 and 9's step kernel, dh0
# product and dRW product, the last two of which row 2 also launches), and
# the libraries each must be in (with drw_reduce, which adds dRW's slices)
TENSOR_CORE_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "lstm_step_mma",
                       "lstm_bwd_step_mma", "lstm_bwd_dh_mma", "drw_mma")
# kernels that must not spill (rows 3-4: their loads stay in registers)
NO_SPILL_KERNELS = ("lrn_fwd", "lrn_bwd")
TENSOR_CORE_LIBS = {"flash_attn": ("flash_fwd",),
                    "flash_attn_bwd": ("flash_bwd_dq", "flash_bwd_dkv"),
                    "lstm_seq": ("lstm_step_mma",),
                    "lstm_cell": ("lstm_step_mma", "lstm_bwd_dh_mma", "drw_mma", "drw_reduce"),
                    "lstm_seq_bwd": ("lstm_bwd_step_mma", "lstm_bwd_dh_mma", "drw_mma",
                                     "drw_reduce")}


def ptxas_report(log: str) -> dict:
    """Registers, stack and spill bytes of each entry function, from the
    ``-Xptxas -v`` lines of an nvcc build log."""
    import re

    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
            out[current] = {}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1) if m.group(1) in out else None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and current:
            out[current].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            out[current]["registers"] = int(m.group(1))
    return out


def sass_counts(lib) -> dict:
    """Per function of ``cuobjdump --dump-sass`` of a built library: its
    HMMA instructions, all its instructions, and those of its largest loop
    (from a backward branch's target to the branch) less the loops nested in
    it: for the LRN kernels, the tile loop without the halo's, what a
    thread issues for its elements of a tile, powf's special-case branches
    included."""
    import re

    from deeplearning4j_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(lib)], check=True, capture_output=True,
                          text=True, timeout=300).stdout
    code = {}  # function -> [(address, instruction)]
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = line.split("Function :", 1)[1].strip()
            code[current] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if current and m:
            code[current].append((int(m.group(1), 16), m.group(2)))
    counts = {}
    for fn, ins in code.items():
        addrs = [a for a, _ in ins]
        loops = []  # (first, last) instruction index of each backward branch's loop
        for i, (a, text) in enumerate(ins):
            m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
            if m and int(m.group(1), 16) <= a:
                loops.append((next(j for j, b in enumerate(addrs) if b >= int(m.group(1), 16)),
                              i))
        loop = 0
        if loops:  # the largest loop, less the loops nested in it (a tile's halo)
            first, last = max(loops, key=lambda fl: fl[1] - fl[0])
            inner = [(f, l) for f, l in loops if first < f and l < last]
            outer = [(f, l) for f, l in inner
                     if not any(f2 < f and l < l2 for f2, l2 in inner)]
            loop = last - first + 1 - sum(l - f + 1 for f, l in outer)
        counts[fn] = {"hmma": sum("HMMA" in t for _, t in ins), "instructions": len(ins),
                      "loop_instructions": loop}
    return counts


def demangle(names) -> dict:
    """Readable names of mangled C++ symbols (the toolkit's cu++filt)."""
    from deeplearning4j_tpu_torch.ops import _build

    names = list(names)
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cu++filt")
    out = subprocess.run([tool], input="\n".join(names), check=True, capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    return dict(zip(names, out))


def phase_sass(build_s: dict) -> dict:
    """Per kernel entry of every built library: registers and spills (the
    build's ``-Xptxas -v``), its SASS instructions, those of its largest
    loop and its HMMA instructions. Fails if an entry of
    ``TENSOR_CORE_KERNELS`` (rows 13-15, the LSTM's forward step and
    backward products) has no HMMA or spills, an entry of
    ``NO_SPILL_KERNELS`` (rows 3-4) spills, or a library of
    ``TENSOR_CORE_LIBS`` lacks one of its entries. Returns the entries by
    library and readable name."""
    from deeplearning4j_tpu_torch.ops import _build

    report, bad = {}, []
    for name in build_s:
        lib = _build.lib_path(name)
        regs = ptxas_report(lib.with_suffix(".log").read_text())
        counts = sass_counts(lib)
        readable = demangle(sorted(set(regs) | set(counts)))
        entries = {}
        for fn in sorted(set(regs) | set(counts)):
            fields = dict(regs.get(fn, {}), **counts.get(fn, {"hmma": 0}))
            entries[readable[fn]] = fields
            spills = fields.get("spill_stores", 0) or fields.get("spill_loads", 0)
            if any(k in fn for k in TENSOR_CORE_KERNELS) and (fields["hmma"] == 0 or spills):
                bad.append(readable[fn])
            if any(k in fn for k in NO_SPILL_KERNELS) and spills:
                bad.append(readable[fn])
        report[name] = entries
        emit("sass", source=name, entries=entries)
    missing = [f"{lib}: {k}" for lib, keys in TENSOR_CORE_LIBS.items() for k in keys
               if not any(k in e for e in report.get(lib, {}))]
    ok = not bad and not missing
    emit("sass_tensor_cores", kernels=list(TENSOR_CORE_KERNELS),
         no_spill_kernels=list(NO_SPILL_KERNELS), failing=bad, missing=missing, ok=ok)
    if not ok:
        raise AssertionError(f"tensor-core kernels without HMMA or kernels with spills: "
                             f"{bad}; missing: {missing}")
    return report


def profile(torch, fn, top: int = 6, groups=None):
    """Run ``fn`` under torch.profiler: wall ms, the card's busy ms (sum of
    kernel intervals on the one stream), the ``top`` kernels by time, the
    copies and layout changes (memcpys, copy and transpose kernels), the
    host's CUDA API calls of API_CALLS, and the ms and launches of each of
    ``groups`` ((label, regex of the kernel
    name) pairs; a kernel counts in the first that matches, else "other")."""
    import re
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
            by_name[e.name][1] += 1
    busy_ms = sum(v[0] for v in by_name.values())
    rows = sorted(([n[:80], ms, c] for n, (ms, c) in by_name.items()), key=lambda r: -r[1])
    copying = re.compile(r"(?i)memcpy|copy|transpose|nchwtonhwc|nhwctonchw")
    out = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
               idle_share=1.0 - busy_ms / wall_ms if wall_ms else None, top_kernels=rows[:top],
               copies=[r for r in rows if copying.search(r[0])],
               api_calls=api_calls(prof.events()))
    if groups:
        sums = defaultdict(lambda: [0.0, 0])
        for n, (ms, c) in by_name.items():
            label = next((lb for lb, rx in groups if re.search(rx, n)), "other")
            sums[label][0] += ms
            sums[label][1] += c
        out["groups"] = dict(sums)
    return out


def one_hot(idx, vocab):
    import numpy as np

    return np.eye(vocab, dtype=np.float32)[idx]


def decode_session(server, first: int, out: dict, key: int) -> None:
    import numpy as np

    sid = server.open()
    tok, rows = first, []
    try:
        for _ in range(DECODE_CHARS):
            row = server.step(sid, one_hot(tok, VOCAB))
            rows.append(row)
            tok = int(np.argmax(row))
    finally:
        server.close(sid)
    out[key] = np.stack(rows)


def decode_sessions(server):
    """SLOTS sessions of DECODE_CHARS chars each through ``server`` at once,
    session s starting from char s. Returns ({s: rows}, seconds)."""
    out: dict = {}
    t0 = time.perf_counter()
    threads = [threading.Thread(target=decode_session, args=(server, s, out, s))
               for s in range(SLOTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    seconds = time.perf_counter() - t0
    if len(out) != SLOTS:
        raise AssertionError(f"{len(out)} of {SLOTS} decode sessions finished")
    return out, seconds


def decode_vs_alone(net, trajectories):
    """Each decode session's rows against the same session run alone through
    ``net.rnn_time_step``: (max abs difference, whether every token agrees)."""
    import numpy as np

    alone_err, same_tokens = 0.0, True
    for s, rows in trajectories.items():
        net.rnn_clear_previous_state()
        tok, alone = s, []
        for _ in range(DECODE_CHARS):
            row = net.rnn_time_step(one_hot(np.array([tok]), VOCAB))[0]
            alone.append(row)
            tok = int(np.argmax(row))
        alone = np.stack(alone)
        alone_err = max(alone_err, float(np.abs(alone - rows).max()))
        same_tokens &= bool((alone.argmax(-1) == rows.argmax(-1)).all())
    return alone_err, same_tokens


# ---- slice 17: the staged training loop (fit_on_device, warmup,
# fit(stage_on_device=K) over the bucketed stager), one training step
# captured in a CUDA graph and replayed once per update, and the prefetch of
# fit (on the card DevicePrefetchIterator: a worker thread fills pinned
# buffers, copied one batch ahead on a side stream)
STAGED_K, STAGED_STEPS = 4, 8  # bench_resnet50's path: 8 updates over 4 staged slots
STAGED_FIT_BATCHES = 9  # fit(stage_on_device=4): windows of 4, 4 and 1 real batch
STAGED_TIMED_WINDOWS = 2  # timed windows of STAGED_K replays (and as many eager updates)
# the staged trajectory against eager fit over the same slots, both with
# cuDNN deterministic: each reading's limit is what two eager runs of the
# same code read against each other in the same phase (the noise), times
# STAGED_NOISE_FACTOR
STAGED_NOISE_FACTOR = 2.0
STAGED_TRAJECTORY_READINGS = ("loss_rel", "change_rel", "state_rel", "updater_rel")
# the first replayed update against eager fit's first update on the same
# batch, at the first-update limits of train_resnet50 (card against CPU)
STAGED_FIRST_KEYS = ("first_loss_rel", "first_change_rel", "first_state_rel")
# the char-RNN recipe on the staged path: char_rnn()'s Adam (lr 1e-3) and
# H=512, standard backprop (the staged loop takes no TBPTT), 8 batches of 64
# of the recipe's ragged sequences (lengths 96..256 from the seed, each
# batch padded to its own longest with its masks), which the stager pads to
# the power-of-two time buckets 128 and 256: windows of 1, 4 and 3 real
# batches, two captured steps a route
STAGED_RECIPE_BATCHES = 8
# LeNet (B=64) and the MNIST MLP with dropout 0.5 (B=512) on fit_on_device
STAGED_MLP_DROPOUT = 0.5
# AlexNet's fit over an iterator of host batches, prefetched: one epoch of
# PREFETCH_BATCHES distinct batches at B=128
PREFETCH_BATCHES = 6
# the wrong prefetch: the side stream held busy for this many cycles before
# each copy (about 0.1 s on the H100's 1.98 GHz), so a buffer refilled
# without waiting for its copy's event holds the next batch when the copy
# runs
PREFETCH_SLEEP_CYCLES = 200_000_000
# host API calls the profiler's CPU side counts per update
API_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
             "cudaGraphLaunch", "cudaMemcpyAsync")


class StagedLossRecorder(LossRecorder):
    """LossRecorder that opts in to the staged loop (its losses arrive after
    each window)."""

    supports_staged = True


def replayed_launches(net) -> dict:
    """The kernel launches that the replays of ``net``'s captured steps
    made: each graph's launches a replay (what its capture counted) times
    its replays."""
    out = {}
    for entry in net._step_graphs._entries.values():
        for k, n in entry.launches.items():
            out[k] = out.get(k, 0) + n * entry.replays
    return out


def api_calls(prof_events) -> dict:
    """Counts of the host's CUDA API calls of API_CALLS among a profile's
    CPU events."""
    from torch.autograd import DeviceType

    counts = dict.fromkeys(API_CALLS, 0)
    for e in prof_events:
        if e.device_type == DeviceType.CPU and e.name in counts:
            counts[e.name] += 1
    return counts


def phase_adam_dev(torch, ad):
    """Row 12's device-scalar entry (``dl4j_adam_update_multi_dev``: lr, bc1
    and bc2 read from a row of the scalar table on the card) at the
    char-RNN's 14 leaves and LeNet's 8 (its convolutions' gradients in the
    main path's strides): against its plain version (``adam_update_reference``
    with 0-d tensors on the card) at ADAM_REL; bit for bit against the
    by-value entry given the same three floats; and a wrong version, the
    previous row's scalars, which the bit-for-bit check must catch. At
    LeNet's leaves, the by-value entry as per-batch ``fit`` calls it is
    timed against what that path would pay for the device-scalar entry: the
    step's three floats copied to the card, then the entry. Returns the max
    abs error against the plain version by case."""
    from deeplearning4j_tpu_torch.nn.updaters import UpdaterConfig, step_scalars

    tx = UpdaterConfig(updater="adam", learning_rate=RECIPE_LR).build()
    table = torch.from_numpy(step_scalars(tx, {"count": 0, "adam": {"count": 0}}, 3)).to(DEVICE)
    row = 2  # the third update's: adam_inputs' scalars
    errs = {}
    for name, shapes in (("char_rnn", None),
                         ("lenet", mnist_leaf_shapes(mnist_models()["lenet"][1]))):
        leaves, sc = adam_inputs(torch, SEED + 20, shapes)
        leaves = conv_grad_layout(leaves)
        gs, ms, vs = (list(x) for x in zip(*leaves))
        b1, b2, eps = sc[3:]
        before = ad.launches["adam_update_dev"]
        got = ad.fused_adam_update_leaves_dev(gs, ms, vs, table[row], b1, b2, eps)
        launched = ad.launches["adam_update_dev"] - before
        lr, bc1, bc2 = table[row].tolist()
        by_value = ad.fused_adam_update_leaves(gs, ms, vs, lr, bc1, bc2, b1, b2, eps)
        wrong = ad.fused_adam_update_leaves_dev(gs, ms, vs, table[row - 1], b1, b2, eps)
        rel, abs_err = dict.fromkeys(("u", "m", "v"), 0.0), 0.0
        bits, wrong_bits = 0.0, 0.0
        for i, (g, m, v) in enumerate(leaves):
            want = ad.adam_update_reference(g, m, v, table[row][0], table[row][1],
                                            table[row][2], b1, b2, eps)
            for n, a, b, c, w in zip(rel, (got[0][i], got[1][i], got[2][i]), want,
                                     (by_value[0][i], by_value[1][i], by_value[2][i]),
                                     (wrong[0][i], wrong[1][i], wrong[2][i])):
                err = float((a - b).abs().max())
                abs_err = max(abs_err, err)
                rel[n] = max(rel[n], err / float(b.abs().max()))
                bits = max(bits, float((a - c).abs().max()))
                wrong_bits = max(wrong_bits, float((w - c).abs().max()))
        torch.cuda.synchronize()
        entry_ms = {"by_value": [], "row_copy_then_dev": []}
        if name == "lenet":
            calls = {"by_value": lambda: ad.fused_adam_update_leaves(
                         gs, ms, vs, lr, bc1, bc2, b1, b2, eps),
                     "row_copy_then_dev": lambda: ad.fused_adam_update_leaves_dev(
                         gs, ms, vs, torch.tensor([lr, bc1, bc2], dtype=torch.float32).to(
                             DEVICE, non_blocking=True), b1, b2, eps)}
            for how in ("by_value", "row_copy_then_dev", "row_copy_then_dev", "by_value"):
                entry_ms[how].append(median_ms(calls[how]))
        check("adam_update_dev", "float32", rel, dict.fromkeys(rel, ADAM_REL), case=name,
              leaves=len(leaves), max_abs_err=abs_err, launches=launched,
              per_batch_entry_ms_runs=entry_ms,
              max_abs_diff_vs_by_value_entry=bits,
              wrong_previous_row_max_abs_diff_vs_by_value=wrong_bits,
              wrong_previous_row_caught=wrong_bits > 0.0, relative_to_largest=True)
        if bits != 0.0 or wrong_bits == 0.0 or launched != 1:
            raise AssertionError(f"adam_update_dev {name}: {bits} from the by-value entry, "
                                 f"wrong row {wrong_bits}, {launched} launches")
        errs[name] = abs_err
    return errs


def staged_slots(torch, seed, k=STAGED_K, b=RES_B):
    """``k`` batches of ResNet's images and labels stacked [k, b, ...] on the
    card (f32, as the host gives them)."""
    import numpy as np

    pairs = [alexnet_images(b, seed + i) for i in range(k)]
    return tuple(torch.as_tensor(np.stack(a), device=DEVICE) for a in zip(*pairs))


def updater_rel(leaves, ref) -> float:
    """The largest relative difference over the updater state's float
    leaves, 0 when they are counts only (plain SGD keeps no trace); counts
    must be equal."""
    import numpy as np

    out = 0.0
    for a, b in zip(leaves, ref):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if a.ndim == 0:
            if a != b:
                return float("inf")
            continue
        out = max(out, float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)))
    return out


def host_leaves(net):
    return [t.detach().float().cpu().numpy() for t in net.updater_state_leaves()]


def staged_resnet_readings(run, ref, host) -> dict:
    """The staged (or second eager) run against an eager run: the first
    update's loss, change and running stats, and the trajectory's losses,
    each tensor's change, running stats and updater state after the last
    step."""
    out = train_readings((run["losses"], run["first"], run["params"]),
                         (ref["losses"], ref["first"], ref["params"]), host)
    out["first_loss_rel"] = float(abs(run["losses"][0] - ref["losses"][0])
                                  / abs(ref["losses"][0]))
    out["first_state_rel"] = state_rel(run["first_state"], ref["first_state"])
    out["state_rel"] = state_rel(run["state"], ref["state"])
    out["updater_rel"] = updater_rel(run["updater"], ref["updater"])
    return out


def eager_resnet_run(torch, conf, host, slots, steps=STAGED_STEPS):
    """``steps`` eager updates (fit, batch on the card) over ``slots`` in
    turn: losses, params and state after the first, params, state and
    updater after the last, and the state after each step."""
    import numpy as np

    from deeplearning4j_tpu_torch import params_to_numpy, state_to_numpy

    xs, ys = slots
    net = resnet_net(conf, host)
    rec = LossRecorder()
    net.set_listeners(rec)
    states = []
    for i in range(steps):
        net.fit((xs[i % len(xs)], ys[i % len(xs)]))
        states.append(state_to_numpy(net))
        if i == 0:
            first = params_to_numpy(net)
    torch.cuda.synchronize()
    out = dict(losses=np.array([float(l) for l in rec.losses]), first=first,
               first_state=states[0], params=params_to_numpy(net), state=states[-1],
               states=states, updater=host_leaves(net))
    del net
    return out


def staged_resnet_run(torch, conf, host, slots, warm=False, fault=None):
    """ResNet's staged run over ``slots``: one replayed update, then 7 over
    the slots rolled by one (so steps 2-8 take slots 1, 2, 3, 0, ...), or
    with ``warm`` ``warmup`` and then one window of 8. Returns the
    readings' inputs and the replay and launch counts of the whole run
    (captures included); ``fault`` "bn_state_not_in_place" rebinds the
    layer state to the step's outputs instead of writing it in place, and
    runs 4 steps only."""
    import numpy as np

    from deeplearning4j_tpu_torch import ops, params_to_numpy, state_to_numpy

    xs, ys = slots
    net = resnet_net(conf, host)
    if fault == "bn_state_not_in_place":
        net._write_state = lambda new: net._set_state_dicts(new)
    torch.cuda.synchronize()
    ops.reset_counters()
    if fault is not None:
        losses = net.fit_on_device(xs, ys, steps=STAGED_K)
        first = first_state = None
    elif warm:
        net.warmup(xs, ys)
        losses = net.fit_on_device(xs, ys, steps=STAGED_STEPS)
        first = first_state = None
    else:
        losses = [net.fit_on_device(xs[:1], ys[:1], steps=1)]
        first, first_state = params_to_numpy(net), state_to_numpy(net)
        rolled = [torch.cat([t[1:], t[:1]]) for t in (xs, ys)]
        losses.append(net.fit_on_device(*rolled, steps=STAGED_STEPS - 1))
        losses = np.concatenate(losses)
        del rolled
    torch.cuda.synchronize()
    out = dict(losses=np.asarray(losses, np.float64), first=first, first_state=first_state,
               params=params_to_numpy(net), state=state_to_numpy(net), updater=host_leaves(net),
               launches={k: v for k, v in ops.counters().items() if v},
               replays=net._step_graphs.replays, graphs=len(net._step_graphs),
               captured_per_replay=[e.launches for e in net._step_graphs._entries.values()],
               replayed_launches=replayed_launches(net))
    del net
    gc_collect(torch)  # the fault's closure holds the net in a cycle, and its graph's pool
    return out


def phase_staged_resnet50(torch, dtype, host, card):
    """ResNet-50 (the conf as it is, B=128, SGD lr 0.1) on the staged loop,
    ``bench_resnet50``'s path: 8 updates over 4 staged slots. With cuDNN
    deterministic: the first replayed update against eager ``fit``'s first
    update on the same batch at train_resnet50's first-update limits; the
    8-step trajectory (losses, each tensor's change, BN's running stats,
    the updater state) against eager ``fit`` over the same slots, within
    STAGED_NOISE_FACTOR times what a second eager run reads against the
    first; ``warmup`` then one window of 8 bit for bit as ``fit_on_device``
    alone; in f32, the wrong version that does not write BN's running stats
    in place must fail the state limit. Then, cuDNN as it is:
    ``fit(stage_on_device=4)`` on a fresh net over a ListDataSetIterator of
    9 host batches (windows of 4, 4 and 1 real; the capture inside it, with
    the prefetch worker running), timed against ``fit`` per batch over the
    same iterator; the captured step's pool; ms per update replayed against
    eager with the batch on the card, a profile of each (the idle share,
    the host's API calls per update). Returns (the launch counts of
    the staged run, its replays, the launches its replays made)."""
    import numpy as np

    from deeplearning4j_tpu_torch import DataSet, ListDataSetIterator, resnet50_conf

    conf = resnet50_conf(dtype=dtype)
    slots = staged_slots(torch, SEED + 40)
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    try:
        eager = [eager_resnet_run(torch, conf, host, slots) for _ in range(2)]
        staged = staged_resnet_run(torch, conf, host, slots)
        warm = staged_resnet_run(torch, conf, host, slots, warm=True)
        fault = (staged_resnet_run(torch, conf, host, slots, fault="bn_state_not_in_place")
                 if dtype == "float32" else None)
    finally:
        torch.backends.cudnn.deterministic = False
    compared_s = time.perf_counter() - t0
    noise = staged_resnet_readings(eager[1], eager[0], host)
    readings = staged_resnet_readings(staged, eager[0], host)
    limits = {k: STAGED_NOISE_FACTOR * noise[k] for k in STAGED_TRAJECTORY_READINGS}
    limits.update({k: RES_TRAIN_LIMITS[dtype][k] for k in STAGED_FIRST_KEYS})
    within = within_limits(readings, limits)
    warm_diff = max(float(np.abs(staged["losses"] - warm["losses"]).max()),
                    max(float(np.abs(a - b).max()) for a, b in
                        zip(named_tensors(staged["params"]).values(),
                            named_tensors(warm["params"]).values())),
                    state_rel(warm["state"], staged["state"]))
    fault_reading = None
    if fault is not None:
        fault_reading = state_rel(fault["state"], eager[0]["states"][STAGED_K - 1])
        fault_noise = state_rel(eager[1]["states"][STAGED_K - 1], eager[0]["states"][STAGED_K - 1])
        fault_caught = fault_reading > STAGED_NOISE_FACTOR * fault_noise
    del slots
    torch.cuda.empty_cache()

    # cuDNN as it is. fit(stage_on_device=4) over 9 host batches on a fresh
    # net: its step is captured inside the fit while the prefetch worker
    # stacks, pins and copies the next windows; then per batch and staged
    # again over the same iterator, in turns
    host_batches = [alexnet_images(RES_B, SEED + 60 + i) for i in range(3)]
    data = ListDataSetIterator([DataSet(*host_batches[i % 3])
                                for i in range(STAGED_FIT_BATCHES)])
    net = resnet_net(conf, host)
    rec = StagedLossRecorder()
    net.set_listeners(rec)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    net.fit(data, stage_on_device=STAGED_K)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t1
    net.set_listeners()
    fit_losses = [float(l) for l in rec.losses]
    fit_replays, fit_graphs = net._step_graphs.replays, len(net._step_graphs)
    fit_ms = {"staged": [], "per_batch": []}
    for how in ("per_batch", "staged", "staged", "per_batch"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        net.fit(data, stage_on_device=STAGED_K if how == "staged" else 0)
        torch.cuda.synchronize()
        fit_ms[how].append((time.perf_counter() - t1) * 1e3 / STAGED_FIT_BATCHES)
    del net, data, host_batches
    gc_collect(torch)

    # the capture and its pool from a fresh net's warmup, then the times
    slots = staged_slots(torch, SEED + 50)
    net = resnet_net(conf, host)
    gc_collect(torch)
    reserved0 = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    net.warmup(*slots)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t1
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    gc_collect(torch)
    pool_gib = (torch.cuda.memory_reserved() - reserved0) / 2 ** 30
    replay_ms = []
    for _ in range(STAGED_TIMED_WINDOWS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        net.fit_on_device(*slots)
        torch.cuda.synchronize()
        replay_ms.append((time.perf_counter() - t1) * 1e3 / STAGED_K)
    # profiled after a window, so no eager update has replaced the layer
    # state's tensors (the next window would copy them back in)
    prof_staged = profile_api(torch, lambda: net.fit_on_device(*slots), STAGED_K,
                              groups=RES_PROFILE_GROUPS)
    on_card = (slots[0][0], slots[1][0])
    eager_ms, _, _ = timed_fit(torch, net, on_card, 1, STAGED_TIMED_WINDOWS * STAGED_K)
    prof_eager = profile_api(torch, lambda: net.fit(on_card), 1, groups=RES_PROFILE_GROUPS)
    graphs = len(net._step_graphs)
    del net, slots, on_card
    gc_collect(torch)
    ok = (within and warm_diff == 0.0 and (fault is None or fault_caught)
          and staged["replays"] == STAGED_STEPS and staged["graphs"] == 1
          and warm["replays"] == STAGED_STEPS and fit_replays == STAGED_FIT_BATCHES
          and fit_graphs == 1
          and len(fit_losses) == STAGED_FIT_BATCHES and bool(np.isfinite(fit_losses).all())
          and graphs == 1 and staged["launches"].get("softmax_xent_fwd", 0) > 0
          and staged["launches"].get("softmax_xent_bwd", 0) > 0)
    emit("staged_resnet50", dtype=dtype, B=RES_B, slots=STAGED_K, steps=STAGED_STEPS,
         cudnn_deterministic_in_comparison=True,
         eager_losses=eager[0]["losses"].tolist(), staged_losses=staged["losses"].tolist(),
         readings_vs_eager=readings, second_eager_vs_eager=noise, limits=limits,
         warmup_then_window_vs_alone_max_abs=warm_diff,
         fault_bn_state_not_in_place_state_rel=fault_reading,
         fault_bn_state_not_in_place_caught=None if fault is None else fault_caught,
         staged_launches_with_capture=staged["launches"], replays=staged["replays"],
         replayed_launches=staged["replayed_launches"],
         captured_launches_per_replay=staged["captured_per_replay"], compared_s=compared_s,
         capture_s=capture_s, peak_allocated_gib_warmup_and_capture=peak_gib,
         graph_pool_gib=pool_gib, fit_stage_on_device=STAGED_K,
         fit_batches=STAGED_FIT_BATCHES, fit_replays=fit_replays, fit_losses=fit_losses,
         fit_with_capture_ms_per_update=fit_s * 1e3 / STAGED_FIT_BATCHES,
         fit_ms_per_update_runs=fit_ms, fit_ms_per_update=min(fit_ms["staged"]),
         per_batch_fit_ms_per_update=min(fit_ms["per_batch"]),
         replayed_ms_per_update_runs=replay_ms,
         replayed_ms_per_update=statistics.median(replay_ms),
         eager_batch_on_card_ms_runs=eager_ms,
         eager_batch_on_card_ms_per_update=statistics.median(eager_ms),
         replayed_idle_share=prof_staged["idle_share"],
         eager_idle_share=prof_eager["idle_share"],
         replayed_api_calls_per_update=prof_staged["api_per_update"],
         eager_api_calls_per_update=prof_eager["api_per_update"],
         replayed_profile=prof_staged, eager_profile=prof_eager, ok=ok, gpu=card)
    if not ok:
        raise AssertionError(f"staged ResNet-50 {dtype} failed its checks")
    return staged["launches"], staged["replays"], staged["replayed_launches"]


def gc_collect(torch):
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def profile_api(torch, fn, updates: int, **kw):
    """``profile`` of ``fn`` (``updates`` updates), with its host API calls
    of API_CALLS per update."""
    out = profile(torch, fn, **kw)
    out["api_per_update"] = {k: v / updates for k, v in out["api_calls"].items()}
    return out


def staged_recipe_batches():
    """STAGED_RECIPE_BATCHES batches of BATCH next-char sequences of the
    seeded sentence (lengths 96..256 from the seed, sorted, so each batch
    is ragged against the next), each padded to its own longest sequence
    with features and labels masks."""
    import numpy as np

    from deeplearning4j_tpu_torch import DataSet

    rng = np.random.default_rng(SEED + 70)
    sentence = rng.integers(0, VOCAB, SENTENCE)
    lengths = np.sort(rng.integers(96, 257, STAGED_RECIPE_BATCHES * BATCH))
    out = []
    for b in range(STAGED_RECIPE_BATCHES):
        lens = lengths[b * BATCH:(b + 1) * BATCH]
        T = int(lens.max())
        x = np.zeros((BATCH, T, VOCAB), np.float32)
        y = np.zeros((BATCH, T, VOCAB), np.float32)
        m = np.zeros((BATCH, T), np.float32)
        for r, n in enumerate(lens):
            seq = sentence[(rng.integers(0, SENTENCE) + np.arange(n + 1)) % SENTENCE]
            x[r, :n] = one_hot(seq[:-1], VOCAB)
            y[r, :n] = one_hot(seq[1:], VOCAB)
            m[r, :n] = 1.0
        out.append(DataSet(x, y, m, m.copy()))
    return out


def staged_recipe_plan(batches):
    """The port's BucketedStager on the host: each window's (real batches,
    slots, time bucket), the windows, and the padded batches their real
    slots hold, in order."""
    from deeplearning4j_tpu_torch import DataSet
    from deeplearning4j_tpu_torch.datasets import BucketedStager
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    plan, windows, padded = [], [], []
    for kind, win in BucketedStager(STAGED_K).plan(batches, MultiLayerNetwork._normalize):
        if kind != "window":
            raise AssertionError("a recipe batch did not stage")
        plan.append((win.n_real, int(win.features[0].shape[0]), int(win.features[0].shape[2])))
        windows.append(win)
        fm, lm = win.features_masks[0], win.labels_masks[0]
        padded += [DataSet(win.features[0][j], win.labels[0][j], fm[j], lm[j])
                   for j in range(win.n_real)]
    return plan, windows, padded


def phase_staged_recipe(torch, host_params, card):
    """The char-RNN recipe on the staged path, f32, on both LSTM routes:
    ``fit(stage_on_device=4)`` over ``staged_recipe_batches``. The windows
    it dispatched (real batches, slots, time bucket) must be the host
    stager's plan; its losses and each param's change are held against
    eager ``fit`` (stage_on_device 0) over the plan's padded batches at the
    recipe's f32 limits; one captured step per time bucket, one replay per
    update. Then staged and eager epochs from the host's batches in turns
    (staged, eager, eager, staged), and the windows replayed and the padded
    batches eagerly from the card, timed. Returns, by
    route, (the launch counts of the first staged epoch, captures
    included; its replays; the launches they made; ms per update replayed;
    ms eager)."""
    import numpy as np

    from deeplearning4j_tpu_torch import (DataSet, ListDataSetIterator, MultiLayerNetwork,
                                          char_rnn, load_jax_params, ops, params_to_numpy)

    conf = char_rnn(VOCAB, HIDDEN, LAYERS)
    assert (conf.updater["updater"], conf.updater["learning_rate"]) == ("adam", RECIPE_LR)
    conf.backprop_type = "standard"  # the staged loop takes no TBPTT
    batches = staged_recipe_batches()
    plan, windows, padded = staged_recipe_plan(batches)
    updates = len(padded)

    def on_card(a):
        return torch.as_tensor(a, device=DEVICE)

    card_windows = [(on_card(w.features[0]), on_card(w.labels[0]),
                     on_card(w.features_masks[0]), on_card(w.labels_masks[0]), w.n_real)
                    for w in windows]
    card_padded = [DataSet(on_card(d.features), on_card(d.labels), on_card(d.features_mask),
                           on_card(d.labels_mask)) for d in padded]
    out = {}
    for route in ("seqfused", "fusedcell"):
        def new_net():
            return load_jax_params(MultiLayerNetwork(conf, lstm_variant=route), host_params)

        net = new_net()
        dispatched = []
        real_dispatch = net._dispatch

        def spy(win):
            xs = win.features[0]
            dispatched.append((int(win.n_real), int(xs.shape[0]), int(xs.shape[2])))
            return real_dispatch(win)

        net._dispatch = spy
        rec = StagedLossRecorder()
        net.set_listeners(rec)
        torch.cuda.synchronize()
        ops.reset_counters()
        net.fit(ListDataSetIterator(batches), stage_on_device=STAGED_K)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.counters().items() if v}
        staged_run = (net, np.array([float(l) for l in rec.losses]), params_to_numpy(net))
        replays = net._step_graphs.replays
        on_card = replayed_launches(net)
        first_windows = list(dispatched)  # the first epoch's
        eager = new_net()
        erec = LossRecorder()
        eager.set_listeners(erec)
        eager.fit(ListDataSetIterator(padded))
        eager_run = (eager, np.array([float(l) for l in erec.losses]), params_to_numpy(eager))
        readings = recipe_readings(staged_run, eager_run, host_params)
        # timed: one more epoch each way from the host's batches, then the
        # windows replayed against eager updates with the batches on the card
        net.set_listeners()
        eager.set_listeners()
        runs = {"staged": lambda: net.fit(ListDataSetIterator(batches),
                                          stage_on_device=STAGED_K),
                "eager": lambda: eager.fit(ListDataSetIterator(padded)),
                "replayed_on_card": lambda: [
                    net.fit_on_device(x, y, steps=n, features_masks=fm, labels_masks=lm,
                                      real_batches=n) for x, y, fm, lm, n in card_windows],
                "eager_on_card": lambda: eager.fit(ListDataSetIterator(card_padded))}
        fit_ms = {how: [] for how in runs}
        for how in ("staged", "eager", "eager", "staged", "replayed_on_card",
                    "eager_on_card"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[how]()
            torch.cuda.synchronize()
            fit_ms[how].append((time.perf_counter() - t0) * 1e3 / updates)
        staged_ms, eager_ms = fit_ms["replayed_on_card"][0], fit_ms["eager_on_card"][0]
        kernels = (("lstm_cell_fwd", "lstm_cell_bwd") if route == "fusedcell" else
                   ("lstm_seq_masked_train_fwd", "lstm_seq_masked_bwd"))
        ok = (first_windows == plan and within_limits(readings, RECIPE_LIMITS["float32"])
              and net.staged_steps_total == 4 * updates and replays == updates
              and len(net._step_graphs) == len({t for _, _, t in plan})
              and all(launches.get(k, 0) > 0 for k in
                      (*kernels, "drw_product", "softmax_xent_fwd", "softmax_xent_bwd",
                       "adam_update_dev")) and not launches.get("adam_update"))
        emit("staged_recipe", route=route, B=BATCH, batches=len(batches),
             batch_lengths=[int(b.features.shape[1]) for b in batches], plan=plan,
             dispatched=first_windows, updates=updates, staged_losses=staged_run[1].tolist(),
             eager_losses=eager_run[1].tolist(), readings_vs_eager=readings,
             limits=RECIPE_LIMITS["float32"], launches_with_captures=launches,
             replays=replays, replayed_launches=on_card, graphs=len(net._step_graphs),
             replayed_ms_per_update=staged_ms, eager_ms_per_update=eager_ms,
             fit_from_host_ms_per_update={"staged": min(fit_ms["staged"]),
                                          "eager": min(fit_ms["eager"])},
             fit_from_host_ms_per_update_runs={"staged": fit_ms["staged"],
                                               "eager": fit_ms["eager"]},
             ok=ok, gpu=card)
        if not ok:
            raise AssertionError(f"the staged recipe on {route} failed its checks")
        out[route] = (launches, replays, on_card, staged_ms, eager_ms)
        del net, eager, staged_run, eager_run
        gc_collect(torch)
    return out


def staged_mnist_slots(torch, name, k=STAGED_K):
    """``k`` batches of the synthetic MNIST for ``name`` stacked on the
    card, and the model's batch and conf."""
    import numpy as np

    from deeplearning4j_tpu_torch import MnistDataSetIterator

    B, conf = mnist_models()[name]
    shape = (-1, 28, 28, 1) if name == "lenet" else (-1, 784)
    pairs = [(ds.features.reshape(shape), ds.labels)
             for ds in MnistDataSetIterator(batch=B, num_examples=B * k)]
    return tuple(torch.as_tensor(np.stack(a), device=DEVICE) for a in zip(*pairs)), B, conf


def staged_pair(torch, conf, host, slots, steps=STAGED_STEPS, fault=None):
    """``steps`` eager updates over ``slots`` in turn and one staged window
    of as many, from the same params and generator state (``fault``, one of
    "lr_bc_baked", "dropout_frozen", applies to the staged run). Returns
    (eager, staged) as (net, losses, params), the staged run's launches,
    (replays, the launches they made), and the ms per update of a further
    window of each."""
    import numpy as np

    from deeplearning4j_tpu_torch import MultiLayerNetwork, load_jax_params, ops
    from deeplearning4j_tpu_torch import params_to_numpy
    from deeplearning4j_tpu_torch.nn import updaters
    from deeplearning4j_tpu_torch.nn.layers import dense

    xs, ys = slots
    eager = load_jax_params(MultiLayerNetwork(conf), host)
    rec = LossRecorder()
    eager.set_listeners(rec)
    for i in range(steps):
        eager.fit((xs[i % len(xs)], ys[i % len(xs)]))
    eager.set_listeners()
    eager_run = (eager, np.array([float(l) for l in rec.losses]), params_to_numpy(eager))
    staged = load_jax_params(MultiLayerNetwork(conf), host)
    real_update, real_dropout = updaters.Updater.update, dense.maybe_dropout
    if fault == "lr_bc_baked":  # the capture reads the count's host floats once
        updaters.Updater.update = lambda self, grads, state, scalars=None, params=None: (
            real_update(self, grads, state, None, params))
    elif fault == "dropout_frozen":  # each mask drawn once, outside the graph
        frozen = {}

        def maybe_dropout(x, rate, train=False, generator=None):
            if not train or rate <= 0.0 or generator is None:
                return x
            if x.shape not in frozen:
                frozen[x.shape] = torch.rand(x.shape, generator=generator,
                                             device=x.device) < 1.0 - rate
            return torch.where(frozen[x.shape], x / (1.0 - rate), torch.zeros_like(x))

        dense.maybe_dropout = maybe_dropout
    try:
        torch.cuda.synchronize()
        ops.reset_counters()
        losses = staged.fit_on_device(xs, ys, steps=steps)
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.counters().items() if v}
    finally:
        updaters.Updater.update, dense.maybe_dropout = real_update, real_dropout
    staged_run = (staged, np.asarray(losses, np.float64), params_to_numpy(staged))
    replays = staged._step_graphs.replays, replayed_launches(staged)
    times = {}
    if fault is None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        staged.fit_on_device(xs, ys, steps=steps)
        torch.cuda.synchronize()
        times["replayed"] = (time.perf_counter() - t0) * 1e3 / steps
        t0 = time.perf_counter()
        for i in range(steps):
            eager.fit((xs[i % len(xs)], ys[i % len(xs)]))
        torch.cuda.synchronize()
        times["eager"] = (time.perf_counter() - t0) * 1e3 / steps
    return eager_run, staged_run, launches, replays, times


def bitwise_equal(run, ref) -> bool:
    """The same losses and params, bit for bit."""
    import numpy as np

    return np.array_equal(run[1], ref[1]) and all(
        np.array_equal(a, b) for a, b in zip(named_tensors(run[2]).values(),
                                             named_tensors(ref[2]).values()))


def phase_staged_lenet(torch, card):
    """LeNet (``lenet_mnist_conf()``, Adam, B=64) on ``fit_on_device``: 8
    replays over 4 staged slots against 8 eager updates over the same slots,
    held by ``recipe_readings`` at MNIST_LIMITS (and read bit for bit); the
    wrong capture that bakes lr and the bias corrections at the capture
    must fail them. ms per update, replayed against eager. Then the MNIST
    MLP (examples/mlp_mnist.py:26-34, B=512) with dropout 0.5: 8 replays
    against eager fit from the same generator state, bit for bit, and the
    losses of a step with the same batch differing from step to step; a
    capture whose generator is not registered must raise, and one whose
    masks are drawn once must fail the bit-for-bit check. Returns
    (launches, replays, the launches they made, ms replayed, ms eager) by
    model."""
    from deeplearning4j_tpu_torch import MultiLayerConfiguration

    out = {}
    slots, B, conf = staged_mnist_slots(torch, "lenet")
    host = conf_host(conf)
    eager_run, staged_run, launches, (replays, on_card), times = staged_pair(
        torch, conf, host, slots)
    readings = recipe_readings(staged_run, eager_run, host, lr=1e-3)
    bitwise = bitwise_equal(staged_run, eager_run)
    baked = recipe_readings(staged_pair(torch, conf, host, slots, fault="lr_bc_baked")[1],
                            eager_run, host, lr=1e-3)
    baked["caught"] = not within_limits(baked, MNIST_LIMITS)
    ok = (within_limits(readings, MNIST_LIMITS) and baked["caught"]
          and replays == STAGED_STEPS
          and all(launches.get(k, 0) > 0 for k in ("softmax_xent_fwd", "softmax_xent_bwd",
                                                     "adam_update_dev"))
          and not launches.get("adam_update"))
    emit("staged_lenet", B=B, slots=STAGED_K, steps=STAGED_STEPS,
         staged_losses=staged_run[1].tolist(), eager_losses=eager_run[1].tolist(),
         readings_vs_eager=readings, limits=MNIST_LIMITS, bit_for_bit=bitwise,
         fault_lr_bc_baked_at_capture=baked, launches_with_capture=launches, replays=replays,
         replayed_launches=on_card,
         replayed_ms_per_update=times["replayed"], eager_ms_per_update=times["eager"],
         ok=ok, gpu=card)
    if not ok:
        raise AssertionError("staged LeNet failed its checks")
    out["lenet"] = (launches, replays, on_card, times["replayed"], times["eager"])

    # the MNIST MLP with dropout: the generator registered with the graph
    slots, B, mlp = staged_mnist_slots(torch, "mlp")
    d = mlp.to_dict()
    d["layers"][0]["dropout"] = STAGED_MLP_DROPOUT
    conf = MultiLayerConfiguration.from_dict(d)
    host = conf_host(conf)
    same = tuple(t[:1].expand(STAGED_K, *t.shape[1:]).contiguous() for t in slots)
    eager_run, staged_run, launches, (replays, on_card), times = staged_pair(
        torch, conf, host, same)
    bitwise = bitwise_equal(staged_run, eager_run)
    distinct = len(set(staged_run[1].tolist()))  # one batch, lr moving: masks differ
    frozen = staged_pair(torch, conf, host, same, fault="dropout_frozen")[1]
    frozen_caught = not bitwise_equal(frozen, eager_run)
    real_register = torch.cuda.CUDAGraph.register_generator_state
    torch.cuda.CUDAGraph.register_generator_state = lambda self, gen: None
    try:
        staged_pair(torch, conf, host, same, steps=2)
        unregistered = "no error"
    except RuntimeError as e:
        unregistered = str(e)[:200]
    finally:
        torch.cuda.CUDAGraph.register_generator_state = real_register
        torch.cuda.synchronize()
    ok = (bitwise and frozen_caught
          and unregistered != "no error" and replays == STAGED_STEPS)
    emit("staged_mlp_dropout", B=B, dropout=STAGED_MLP_DROPOUT, steps=STAGED_STEPS,
         one_batch_every_step=True, staged_losses=staged_run[1].tolist(),
         eager_losses=eager_run[1].tolist(), bit_for_bit=bitwise,
         distinct_step_losses=distinct, fault_masks_drawn_once_caught=frozen_caught,
         fault_masks_drawn_once_losses=frozen[1].tolist(),
         fault_generator_not_registered=unregistered, launches_with_capture=launches,
         replays=replays, replayed_launches=on_card, replayed_ms_per_update=times["replayed"],
         eager_ms_per_update=times["eager"], ok=ok, gpu=card)
    if not ok:
        raise AssertionError("the staged MLP with dropout failed its checks")
    out["mlp"] = (launches, replays, on_card, times["replayed"], times["eager"])
    gc_collect(torch)
    return out


def prefetch_variant(torch, wait: bool):
    """DevicePrefetchIterator with its side stream held busy before each
    copy; with ``wait`` false, the wrong version: a pinned buffer is refilled
    without waiting for the event of its last copy."""
    from deeplearning4j_tpu_torch.datasets import DevicePrefetchIterator

    class Delayed(DevicePrefetchIterator):
        def _to_device(self, host, dev, side):
            with torch.cuda.stream(side):
                torch.cuda._sleep(PREFETCH_SLEEP_CYCLES)
            return super()._to_device(host, dev, side)

        def _wait_copied(self, copied):
            if wait:
                super()._wait_copied(copied)

    return Delayed


def phase_prefetch_alexnet(torch, dtype, host, card):
    """AlexNet (the conf as it is, dropout 0.5, B=128) trained on an epoch of
    PREFETCH_BATCHES distinct host batches. With cuDNN deterministic,
    ``fit`` over a ListDataSetIterator (DevicePrefetchIterator: a worker
    thread fills a ring of pinned buffers, each batch copied one batch ahead
    on a side stream) against the synchronous path (each batch copied from
    pageable memory as the update takes it): losses and params bit for bit;
    again with the side stream held busy before each copy, right, and the
    wrong version that refills a buffer before its copy has finished, which
    must differ. Then, cuDNN as it is, ms per update of an epoch: the
    synchronous copy, the prefetching fit, and the batches already on the
    card, in turns. Returns (the prefetching epoch's launch counts, ms)."""
    import numpy as np

    from deeplearning4j_tpu_torch import (DataSet, ListDataSetIterator, MultiLayerNetwork,
                                          alexnet_conf, load_jax_params, ops, params_to_numpy)
    from deeplearning4j_tpu_torch.nn import multilayer

    conf = alexnet_conf(dtype=dtype)
    batches = [alexnet_images(ALEX_B, SEED + 80 + i) for i in range(PREFETCH_BATCHES)]
    on_card = [tuple(torch.as_tensor(a, device=DEVICE) for a in b) for b in batches]

    def sync_epoch(net, data):
        for x, y in data:
            net._fit_batch(DataSet(x, y))

    def run(how, variant=None):
        net = load_jax_params(MultiLayerNetwork(conf), host)
        net._updater_ready()
        rec = LossRecorder()
        net.set_listeners(rec)
        real = multilayer.DevicePrefetchIterator
        if variant is not None:
            multilayer.DevicePrefetchIterator = variant
        try:
            torch.cuda.synchronize()
            ops.reset_counters()
            if how == "sync":
                sync_epoch(net, batches)
            else:
                net.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]))
            torch.cuda.synchronize()
        finally:
            multilayer.DevicePrefetchIterator = real
        net.set_listeners()
        return (net, np.array([float(l) for l in rec.losses]), params_to_numpy(net),
                {k: v for k, v in ops.counters().items() if v})

    torch.backends.cudnn.deterministic = True
    try:
        sync = run("sync")
        pre = run("prefetch")
        delayed = run("prefetch", prefetch_variant(torch, wait=True))
        wrong = run("prefetch", prefetch_variant(torch, wait=False))
    finally:
        torch.backends.cudnn.deterministic = False
    same = bitwise_equal(pre[:3], sync[:3])
    delayed_same = bitwise_equal(delayed[:3], sync[:3])
    wrong_caught = not bitwise_equal(wrong[:3], sync[:3])
    launches = pre[3]
    net = pre[0]
    del sync, delayed, wrong

    def timed(how):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if how == "sync":
            sync_epoch(net, batches)
        elif how == "prefetch":
            net.fit(ListDataSetIterator([DataSet(x, y) for x, y in batches]))
        else:
            net.fit(ListDataSetIterator([DataSet(x, y) for x, y in on_card]))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / PREFETCH_BATCHES

    order = ("sync", "prefetch", "on_card", "on_card", "prefetch", "sync")
    times = {how: [] for how in order}
    for how in order:
        times[how].append(timed(how))
    ok = (same and delayed_same and wrong_caught
          and all(launches.get(k, 0) > 0 for k in ("lrn_fwd", "lrn_bwd", "softmax_xent_fwd",
                                                     "softmax_xent_bwd")))
    emit("prefetch_alexnet", dtype=dtype, B=ALEX_B, batches=PREFETCH_BATCHES, dropout=0.5,
         cudnn_deterministic_in_comparison=True, prefetch_vs_sync_bit_for_bit=same,
         delayed_copy_vs_sync_bit_for_bit=delayed_same,
         fault_buffer_refilled_before_its_copy_caught=wrong_caught,
         prefetch_losses=pre[1].tolist(), kernel_launches=launches,
         ms_per_update_runs=times,
         sync_host_copy_ms_per_update=min(times["sync"]),
         prefetch_host_copy_ms_per_update=min(times["prefetch"]),
         batch_on_card_ms_per_update=min(times["on_card"]), ok=ok, gpu=card)
    if not ok:
        raise AssertionError(f"AlexNet's prefetch {dtype} failed its checks")
    del net, pre, on_card
    gc_collect(torch)
    return launches, min(times["prefetch"])


def phases_slice17(torch, card, res_host, alex_host, host_params):
    """The slice's phases, each counting from 0: ResNet-50 staged (f32,
    bf16), the recipe staged on both routes, LeNet and the MLP staged,
    AlexNet's prefetch (f32, bf16). Returns, by path, the launch counts of
    its runs (captures included), its replays, the launches its replays
    made (``replayed_launches``) and its ms per update (replayed and eager,
    or the prefetching fit's)."""
    launches, replays, replayed, times = {}, {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        path = f"resnet50_{dtype}"
        launches[path], replays[path], replayed[path] = phase_staged_resnet50(
            torch, dtype, res_host, card)
    recipe = phase_staged_recipe(torch, host_params, card)
    lenet = phase_staged_lenet(torch, card)
    for path, (counts, n, on_card, staged_ms, eager_ms) in [
            *((f"recipe_{route}", r) for route, r in recipe.items()), *lenet.items()]:
        launches[path], replays[path], replayed[path] = counts, n, on_card
        times[path] = (staged_ms, eager_ms)
    for dtype in ("float32", "bfloat16"):
        path = f"prefetch_alexnet_{dtype}"
        launches[path], times[path] = phase_prefetch_alexnet(torch, dtype, alex_host, card)
    if not all(launches[p].get("adam_update_dev") for p in
               ("recipe_seqfused", "recipe_fusedcell", "lenet", "mlp")):
        raise AssertionError("adam_update_dev did not launch on a staged Adam path")
    return launches, replays, replayed, times


# ---- slice 18: the recurrent ComputationGraph (TBPTT, rnn_time_step,
# DecodeServer over a graph) and the sequence layers. The char-RNN above as
# a graph (in -> lstm0 -> lstm1 -> out), trained with TBPTT(50) and Adam at
# char_rnn()'s lr 1e-3, served, streamed and decoded against the
# MultiLayerNetwork from the same weights; a sequence classifier over the
# recipe's bucketed text; the transformer block of examples/long_context.py
# whole, its MixtureOfExpertsLayer at twice the example's width.
GRAPH_STREAM_STEPS = 32  # rnn_time_step one step at a time against output()
GRAPH_TIMED_BATCHES = 3  # timed TBPTT batches of the graph and of the MLN each
GRAPH_TICKS = 20  # timed decode ticks (a masked [SLOTS, 1, V] step) of each
# the sequence classifier: next char after each sequence of the recipe's
# text, trained at the recipe's buckets on the card (two epochs, 4 updates)
# and held against the same training on the CPU at shorter ones
SEQ_CPU_BUCKETS = (32, 64)
SEQ_EPOCHS = 2
# the MoE block: examples/long_context.py's MixtureOfExpertsLayer at twice
# its width (n_out 512 = the attention net's, 4 experts, hidden 1024,
# capacity factor 2, residual) after each LayerNorm of the attention net
MOE_EXPERTS, MOE_HIDDEN, MOE_CAPACITY = 4, 1024, 2.0
MOE_TIMED_EPOCHS = 2  # timed epochs of 2 updates at T 2048 and 4096
# a profiled T=4096 update of the MoE block, by kernel family
MOE_PROFILE_GROUPS = [("flash attention (rows 13-15)", r"flash_"),
                      ("products (einsums, projections)", r"(?i)gemm|matmul|cutlass|sm90"),
                      ("one-hot, cumsum, compare", r"(?i)compare|cumsum|scan|eq_|one_hot"),
                      ("reductions", r"(?i)reduce"),
                      ("copies", r"(?i)memcpy|copy|transpose")]
# the MoE block's training on the card against the CPU at T <= 512, by the
# recipe's readings. At lr 3e-3 through 1024-wide experts its first
# updates raise the loss, and a start moved by one f32 rounding (each
# weight times 1 + 2^-23 n) moves the 4 updates as far as the card reads
# (scripts/moe_train_sensitivity.py, 6 draws, CPU): f32 loss 7e-6 to
# 4.5e-5, change 0.003-0.029, max 0.004-0.011, 792-11,384 elements over
# lr/10; bf16 loss 0.003-0.072, change 0.16-0.32, max 0.020, 1.0M-2.8M
# elements. Pad tokens claiming capacity read f32 0.022, 0.97, 0.023 and
# 4.93M; bf16 0.022, 0.95, 0.023 and 4.99M. So the attention net's limits
# (ATTN_TRAIN_LIMITS) would fail a right run; these sit between. In bf16
# only the change and the element count tell the fault from rounding, and
# the largest difference is bounded by Adam (2 lr for each of 4 updates,
# 0.024) in both dtypes.
MOE_TRAIN_LIMITS = {
    "float32": {"loss_rel": 5e-4, "change_rel": 0.2, "max_param_abs": 0.02,
                "elements_over_lr_tenth": 200000},
    "bfloat16": {"loss_rel": 0.2, "change_rel": 0.6, "max_param_abs": 0.024,
                 "elements_over_lr_tenth": 4000000},
}
# the kernels each of slice 18's paths launches; for each, the main path's
# row whose shape it has (its error and times, of this run, go in the
# path's row), or None: held and timed at the path's own shape
# (kernels_slice18)
SLICE18_ROWS = {
    "graph_char_rnn": {"lstm_seq_lean": "lstm_seq_lean",
                       "lstm_seq_lean_masked": "lstm_seq_lean_masked",
                       "lstm_seq_train_fwd": None, "lstm_seq_bwd": None, "drw_product": None,
                       "softmax_xent_fwd": None, "softmax_xent_bwd": None,
                       "adam_update": "adam_update"},
    "seq_classifier": {"lstm_seq_masked_train_fwd": None, "lstm_seq_masked_bwd": None,
                       "drw_product": None, "softmax_xent_fwd": None, "softmax_xent_bwd": None,
                       "adam_update": None},
    "moe_attention": {**{k: k for k in ATTN_KERNELS}, "softmax_xent_fwd": "softmax_xent_fwd",
                      "softmax_xent_bwd": "softmax_xent_bwd", "adam_update": None},
}


def graph_char_rnn_conf(dtype):
    """The char-RNN as a ComputationGraph: in -> lstm0 -> ... -> out, with
    char_rnn()'s Adam and TBPTT(50)."""
    from deeplearning4j_tpu_torch import (ComputationGraphConfiguration, GravesLSTM, InputType,
                                          RnnOutputLayer)

    b = (ComputationGraphConfiguration.builder().add_inputs("in")
         .set_input_types(InputType.recurrent(VOCAB)))
    prev = "in"
    for i in range(LAYERS):
        b = b.add_layer(f"lstm{i}", GravesLSTM(n_out=HIDDEN, activation="tanh"), prev)
        prev = f"lstm{i}"
    return (b.add_layer("out", RnnOutputLayer(n_out=VOCAB, activation="softmax",
                                              loss="mcxent"), prev)
            .set_outputs("out").updater({"updater": "adam", "learning_rate": RECIPE_LR})
            .tbptt(TBPTT, TBPTT).dtype(dtype).seed(SEED).build())


def graph_host(host_params) -> dict:
    """The char-RNN's per-layer weights by the graph's vertex names."""
    return {**{f"lstm{i}": host_params[i] for i in range(LAYERS)}, "out": host_params[LAYERS]}


def as_layer_list(params) -> list:
    """A graph's params_to_numpy in the MultiLayerNetwork's layer order."""
    return [params[f"lstm{i}"] for i in range(LAYERS)] + [params["out"]]


def segment_reset(net):
    """A wrong graph TBPTT: every segment starts from zero h/c instead of the
    previous segment's. Returns what undoes it."""
    real = net._loss

    def wrong(*args, rnn_state=None, **kw):
        if rnn_state is not None:
            rnn_state = net._init_rnn_states(args[0][0].shape[0])
        return real(*args, rnn_state=rnn_state, **kw)

    net._loss = wrong
    return lambda: delattr(net, "_loss")


def tbptt_readings(run, ref) -> dict:
    """Graph TBPTT against the MLN's: each segment's loss relative to the
    MLN's, the largest param difference, and whether all are bit for bit."""
    import numpy as np

    losses, params = run
    ref_losses, ref_params = ref
    same = (losses.shape == ref_losses.shape and bool((losses == ref_losses).all())
            and all(np.array_equal(p[k], q[k]) for p, q in zip(params, ref_params) for k in p))
    return {"loss_rel": float(np.max(np.abs(losses - ref_losses) / np.abs(ref_losses)))
            if losses.shape == ref_losses.shape else float("inf"),
            "param_abs": max(float(np.abs(p[k] - q[k]).max())
                             for p, q in zip(params, ref_params) for k in p),
            "bit_for_bit": same}


def phase_train_graph_char_rnn(torch, dtype, host_params, card):
    """One full-width batch (B=64, T=256) through graph TBPTT on the card,
    against the MultiLayerNetwork char-RNN (char_rnn(): the same layers, Adam
    and TBPTT) from the same weights on the card: each segment's loss and
    every param after the batch at TRAIN_LOSS_RTOL / TRAIN_PARAM_ATOL; the
    launches exactly; a graph whose segments restart from zero h/c must
    read above the limits. Then the update timed against the MLN's, and
    one update of each profiled (the card's idle share: the host's part).
    Returns (the graph's launches, the timings)."""
    import numpy as np

    from deeplearning4j_tpu_torch import (ComputationGraph, MultiLayerNetwork, char_rnn,
                                          load_jax_params, ops, params_to_numpy)

    batch = char_batches(1 + GRAPH_TIMED_BATCHES, SEED + 20)
    updates = -(-STEPS // TBPTT)

    def net_of(kind):
        if kind == "graph":
            return load_jax_params(ComputationGraph(graph_char_rnn_conf(dtype)),
                                   graph_host(host_params))
        return load_jax_params(MultiLayerNetwork(char_rnn(VOCAB, HIDDEN, LAYERS, dtype=dtype)),
                               host_params)

    def run(kind, fault=False):
        net = net_of(kind)
        undo = segment_reset(net) if fault else (lambda: None)
        rec = LossRecorder()
        net.set_listeners(rec)
        torch.cuda.synchronize()
        ops.reset_counters()
        try:
            net.fit(batch[0])
            torch.cuda.synchronize()
        finally:
            undo()
        launches = {k: v for k, v in ops.counters().items() if v}
        net.set_listeners()
        params = params_to_numpy(net)
        return net, launches, (np.array([float(l) for l in rec.losses]),
                               as_layer_list(params) if kind == "graph" else params)

    gnet, g_launches, g_run = run("graph")
    iterations, streamed = gnet.iteration, gnet.rnn_get_previous_state("lstm0")
    mnet, m_launches, m_run = run("mln")
    readings = tbptt_readings(g_run, m_run)
    within = (readings["loss_rel"] <= TRAIN_LOSS_RTOL[dtype]
              and readings["param_abs"] <= TRAIN_PARAM_ATOL[dtype])
    fault = tbptt_readings(run("graph", fault=True)[2], m_run)
    fault["caught"] = not (fault["loss_rel"] <= TRAIN_LOSS_RTOL[dtype]
                           and fault["param_abs"] <= TRAIN_PARAM_ATOL[dtype])
    expected = {"lstm_seq_train_fwd": LAYERS * updates, "lstm_seq_bwd": LAYERS * updates,
                "drw_product": LAYERS * updates, "softmax_xent_fwd": updates,
                "softmax_xent_bwd": updates, "adam_update": updates * adam_launches(mnet)}

    times = {"graph": [], "mln": []}
    for x, y in batch[1:]:
        for kind, net in (("graph", gnet), ("mln", mnet), ("mln", mnet), ("graph", gnet)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net.fit((x, y))
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t0) * 1e3 / updates)
    profiles = {kind: profile(torch, lambda n=net: n.fit(batch[1]), groups=LSTM_PROFILE_GROUPS)
                for kind, net in (("graph", gnet), ("mln", mnet))}
    ms = {kind: statistics.median(t) for kind, t in times.items()}
    ok = (g_run[0].shape == (updates,) and bool(np.isfinite(g_run[0]).all()) and within
          and fault["caught"] and g_launches == m_launches == expected
          and iterations == updates and streamed is None)
    emit("train_graph_char_rnn", dtype=dtype, B=BATCH, T=STEPS, tbptt=TBPTT, updates=updates,
         losses=g_run[0].tolist(), mln_losses=m_run[0].tolist(), readings_vs_mln=readings,
         loss_rtol=TRAIN_LOSS_RTOL[dtype], param_atol=TRAIN_PARAM_ATOL[dtype],
         fault_segment_reset_vs_mln=fault, kernel_launches=g_launches,
         mln_kernel_launches=m_launches, expected_launches=expected,
         ms_per_update=ms, ms_per_update_runs=times,
         update_profile={kind: {k: p[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                                  "groups", "api_calls")}
                         for kind, p in profiles.items()},
         profile_note="one fit() of a 256-step batch (6 TBPTT updates) under the profiler; "
                      "idle_share: the card's share of the wall time without a kernel, the "
                      "host's part", ok=ok, gpu=card)
    if not ok:
        raise AssertionError(f"graph char-RNN training {dtype} failed its checks")
    return g_launches, {"ms_per_update": ms, "idle_share": {
        kind: p["idle_share"] for kind, p in profiles.items()}}


def phase_serve_graph_char_rnn(torch, host_params, x, mln, mln_trajectories, card):
    """The graph char-RNN (f32) served: ``output`` at T=256 against the
    MultiLayerNetwork's from the same weights; ``rnn_time_step`` one step at
    a time over GRAPH_STREAM_STEPS steps against ``output``; DecodeServer
    over the graph, SLOTS sessions of DECODE_CHARS chars, against the MLN
    server's sessions of the main path, then a second wave in the reused
    slots against each session alone; a server whose slot reset skips the
    graph's state must read above DECODE_ATOL in that second wave. Then a
    decode tick (a masked [SLOTS, 1, V] step) timed on both nets. Returns
    (the graph's launches, the timings)."""
    import numpy as np

    from deeplearning4j_tpu_torch import ComputationGraph, DecodeServer, load_jax_params, ops

    gnet = load_jax_params(ComputationGraph(graph_char_rnn_conf("float32")),
                           graph_host(host_params))
    torch.cuda.synchronize()
    ops.reset_counters()
    probs = gnet.output(x)
    gnet.rnn_clear_previous_state()
    steps = np.stack([gnet.rnn_time_step(x[:, t]) for t in range(GRAPH_STREAM_STEPS)], 1)
    server = DecodeServer(gnet, capacity=SLOTS, max_delay_ms=2.0)
    try:
        wave1, wave1_s = decode_sessions(server)
        wave2, _ = decode_sessions(server)
        ticks = server.ticks
    finally:
        server.stop()
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.counters().items() if v}
    out_err = float(np.abs(probs - mln.output(x)).max())
    step_err = float(np.abs(steps - probs[:, :GRAPH_STREAM_STEPS]).max())
    mln_err = max(float(np.abs(wave1[s] - mln_trajectories[s]).max()) for s in wave1)
    alone_err, same_tokens = decode_vs_alone(gnet, wave2)

    bad = DecodeServer(gnet, capacity=SLOTS, max_delay_ms=2.0)
    bad._reset_slot = lambda slot: None  # the slot's rows keep the last session's h/c
    try:
        decode_sessions(bad)
        stale, _ = decode_sessions(bad)
    finally:
        bad.stop()
    stale_err = decode_vs_alone(gnet, stale)[0]

    tick_x = one_hot(np.arange(SLOTS) % VOCAB, VOCAB)[:, None]
    tick_mask = (np.arange(SLOTS) % 2 == 0).astype(np.float32)[:, None]
    tick_ms = {"graph": [], "mln": []}
    for net in (gnet, mln):
        net.rnn_clear_previous_state()
    for _ in range(GRAPH_TICKS):
        for kind, call in (("graph", lambda: gnet.rnn_time_step(tick_x, features_masks=tick_mask)),
                           ("mln", lambda: mln.rnn_time_step(tick_x, features_mask=tick_mask))):
            t0 = time.perf_counter()
            call()  # returns a host array: the step has finished
            tick_ms[kind].append((time.perf_counter() - t0) * 1e3)
    ms = {kind: statistics.median(t) for kind, t in tick_ms.items()}
    ok = (probs.shape == (BATCH, STEPS, VOCAB) and bool(np.isfinite(probs).all())
          and out_err <= SERVE_ATOL["float32"] and step_err <= DECODE_ATOL
          and mln_err <= DECODE_ATOL and alone_err <= DECODE_ATOL and same_tokens
          and stale_err > DECODE_ATOL and launches.get("lstm_seq_lean", 0) > 0
          and launches.get("lstm_seq_lean_masked", 0) > 0)
    emit("serve_graph_char_rnn", B=BATCH, T=STEPS, output_max_abs_err_vs_mln=out_err,
         output_atol=SERVE_ATOL["float32"], stream_steps=GRAPH_STREAM_STEPS,
         stream_max_abs_err_vs_output=step_err, sessions=SLOTS, chars_each=DECODE_CHARS,
         ticks=ticks, wave1_s=wave1_s, wave1_max_abs_err_vs_mln_server=mln_err,
         wave2_max_abs_err_vs_alone=alone_err, wave2_same_tokens_as_alone=same_tokens,
         fault_reset_skips_graph_state_max_abs_err_vs_alone=stale_err,
         atol=DECODE_ATOL, kernel_launches=launches, decode_tick_ms=ms,
         decode_tick_ms_runs=tick_ms, ok=ok, gpu=card)
    if not ok:
        raise AssertionError("graph char-RNN serving failed its checks")
    return launches, {"decode_tick_ms": ms}


def seq_classifier_conf():
    """ids -> RnnEmbedding(96 -> 512) -> GravesLSTM(512) -> Convolution1D
    (512, kernel 3, same) -> LastTimeStepVertex (the ids' mask) -> softmax
    over the next char. The convolution sits after the LSTM: a masked LSTM
    holds h over the pad steps, so right after it the last step and the
    last live step are equal, and a wrong LastTimeStep would read the same;
    the convolution's window makes them differ."""
    from deeplearning4j_tpu_torch import (ComputationGraphConfiguration, Convolution1DLayer,
                                          GravesLSTM, InputType, LastTimeStepVertex,
                                          OutputLayer, RnnEmbeddingLayer)

    return (ComputationGraphConfiguration.builder().add_inputs("ids")
            .set_input_types(InputType.recurrent(1))
            .add_layer("emb", RnnEmbeddingLayer(n_in=VOCAB, n_out=HIDDEN), "ids")
            .add_layer("lstm", GravesLSTM(n_out=HIDDEN, activation="tanh"), "emb")
            .add_layer("conv", Convolution1DLayer(n_out=HIDDEN, kernel=3), "lstm")
            .add_vertex("last", LastTimeStepVertex(mask_input="ids"), "conv")
            .add_layer("out", OutputLayer(n_out=VOCAB, activation="softmax", loss="mcxent"),
                       "last")
            .set_outputs("out").updater({"updater": "adam", "learning_rate": RECIPE_LR})
            .seed(SEED).build())


def seq_classifier_params(seed) -> dict:
    """Random weights from a numpy seed by vertex name (xavier-normal
    matrices, zero biases; the LSTM as char_rnn_params draws it)."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def w(shape, fan_in, fan_out):
        return rng.normal(0.0, (2.0 / (fan_in + fan_out)) ** 0.5, shape)

    H = HIDDEN
    b = np.zeros(4 * H)
    b[H:2 * H] = 1.0
    return {"emb": {"W": w((VOCAB, H), VOCAB, H)},
            "lstm": {"W": w((H, 4 * H), H, H), "RW": rng.normal(0.0, (1.0 / H) ** 0.5, (H, 4 * H)),
                     "b": b, "pF": rng.normal(0.0, 0.1, H), "pI": rng.normal(0.0, 0.1, H),
                     "pO": rng.normal(0.0, 0.1, H)},
            "conv": {"W": w((3, H, H), 3 * H, 3 * H), "b": np.zeros(H)},
            "out": {"W": w((H, VOCAB), H, VOCAB), "b": np.zeros(VOCAB)}}


def seq_sequences(lo, mid, hi, seed):
    """(ids [L, 1] as floats, the next char's one-hot [V]) of the seeded
    sentence: RECIPE_SHORT lengths in lo..mid and RECIPE_LONG in mid+1..hi,
    shuffled."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sentence = rng.integers(0, VOCAB, SENTENCE)
    lengths = np.concatenate([rng.integers(lo, mid + 1, RECIPE_SHORT),
                              rng.integers(mid + 1, hi + 1, RECIPE_LONG)])
    rng.shuffle(lengths)
    out = []
    for n in lengths:
        seq = sentence[(rng.integers(0, SENTENCE) + np.arange(n + 1)) % SENTENCE]
        out.append((seq[:-1, None].astype(np.float32), one_hot(seq[-1], VOCAB)))
    return out


def wrong_last_step():
    """A wrong LastTimeStepVertex: x[:, -1] under a mask too. Returns what
    undoes it."""
    from deeplearning4j_tpu_torch.nn.graph import vertices

    real = vertices.LastTimeStepVertex.apply
    vertices.LastTimeStepVertex.apply = (
        lambda self, params, inputs, state, **kw: (inputs[0][:, -1, :], state))
    return lambda: setattr(vertices.LastTimeStepVertex, "apply", real)


def phase_train_seq_classifier(torch, card):
    """The sequence classifier at the char-RNN's widths (f32): Adam over the
    recipe's bucketed text (B=64 padded to 128 and 256; rows 8-9 masked,
    10-12, the plain embedding and Conv1D) on the card with exact launch
    counts; the same training at SEQ_CPU_BUCKETS on the card and on the CPU,
    held by ``recipe_readings`` at RECIPE_LIMITS; the same training on the
    card with a LastTimeStep that takes x[:, -1] under the mask, which must
    fail them; then one timed epoch. Returns (launches, the timing, the
    long batch's mask [T, B, 1], the param leaf shapes)."""
    import numpy as np

    from deeplearning4j_tpu_torch import (BucketingSequenceIterator, ComputationGraph,
                                          load_jax_params, ops, params_to_numpy)

    host = seq_classifier_params(SEED + 30)
    conf = seq_classifier_conf()
    it = BucketingSequenceIterator(seq_sequences(96, 128, 256, SEED + 31), batch=BATCH,
                                   boundaries=RECIPE_BUCKETS)
    shapes = [ds.features.shape[:2] for ds in it]
    if sorted(shapes) != [(BATCH, 128), (BATCH, 256)]:
        raise AssertionError(f"classifier batches {shapes}")
    updates = SEQ_EPOCHS * len(shapes)
    net = load_jax_params(ComputationGraph(conf), host)
    torch.cuda.synchronize()
    ops.reset_counters()
    net.fit(it, epochs=SEQ_EPOCHS)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.counters().items() if v}
    leaves = sum(len(p) for p in net._leaves())
    expected = {"lstm_seq_masked_train_fwd": updates, "lstm_seq_masked_bwd": updates,
                "drw_product": updates, "softmax_xent_fwd": updates,
                "softmax_xent_bwd": updates, "adam_update": updates * adam_launches(net)}

    small = BucketingSequenceIterator(
        seq_sequences(SEQ_CPU_BUCKETS[0] - 8, SEQ_CPU_BUCKETS[0], SEQ_CPU_BUCKETS[1],
                      SEED + 32), batch=BATCH, boundaries=SEQ_CPU_BUCKETS)

    def train_small(dev, fault=False):
        n = load_jax_params(ComputationGraph(conf, device=dev), host)
        rec = LossRecorder()
        n.set_listeners(rec)
        undo = wrong_last_step() if fault else (lambda: None)
        try:
            n.fit(small, epochs=SEQ_EPOCHS)
        finally:
            undo()
        n.set_listeners()
        return n, np.array([float(l) for l in rec.losses]), list(params_to_numpy(n).values())

    runs = {dev: train_small(dev) for dev in ("cuda", "cpu")}
    seed_list = [host.get(name, {}) for name in net._topo]  # params_to_numpy's order
    readings = recipe_readings(runs["cuda"], runs["cpu"], seed_list)
    lim = RECIPE_LIMITS["float32"]
    within = within_limits(readings, lim)
    fault = recipe_readings(train_small("cuda", fault=True), runs["cpu"], seed_list)
    fault["caught"] = not within_limits(fault, lim)
    cpu_losses = runs["cpu"][1]
    loss_fall = float(cpu_losses[:2].mean() - cpu_losses[-2:].mean())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(it)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(shapes)
    long_batch = next(ds for ds in it if ds.features.shape[1] == STEPS)
    mask = np.ascontiguousarray(np.asarray(long_batch.features_mask, np.float32).T[..., None])
    ok = (launches == expected and within and fault["caught"] and loss_fall > 0.0
          and net.iteration == updates + len(shapes))
    emit("train_seq_classifier", B=BATCH, batches=[list(s) for s in shapes], updates=updates,
         param_leaves=leaves, kernel_launches=launches, expected_launches=expected,
         compared_at=list(SEQ_CPU_BUCKETS), cpu_losses=cpu_losses.tolist(),
         card_losses=runs["cuda"][1].tolist(), cpu_loss_fall=loss_fall,
         readings_vs_cpu=readings, limits=lim, fault_last_step_unmasked_vs_cpu=fault,
         ms_per_update=ms, real_chars_per_s=sum(len(x) for x, _ in it.sequences) / (
             ms * len(shapes) / 1e3), ok=ok, gpu=card)
    if not ok:
        raise AssertionError("sequence classifier training failed its checks")
    leaf_shapes = [np.shape(p[k]) for p in params_to_numpy(net).values() for k in p]
    return launches, {"ms_per_update": ms}, mask, leaf_shapes


def moe_attention_conf(dtype):
    """The attention net with examples/long_context.py's MoE after each
    LayerNorm: [SelfAttention(flash), LayerNorm, MoE] x 2, then the head."""
    from deeplearning4j_tpu_torch import MixtureOfExpertsLayer

    conf = attention_conf(dtype)
    for i in (4, 2):
        conf.layers.insert(i, MixtureOfExpertsLayer(
            n_out=ATTN_N, n_experts=MOE_EXPERTS, hidden=MOE_HIDDEN,
            capacity_factor=MOE_CAPACITY, residual=True))
    return conf


def moe_attention_params(seed):
    """attention_params with each MoE's weights after its LayerNorm:
    xavier-normal gate and expert matrices, zero biases."""
    import numpy as np

    rng = np.random.default_rng(seed + 1)

    def w(shape, fan_in, fan_out):
        return rng.normal(0.0, (2.0 / (fan_in + fan_out)) ** 0.5, shape)

    def moe():
        E, N, Hd = MOE_EXPERTS, ATTN_N, MOE_HIDDEN
        return {"Wg": w((N, E), N, E), "W1": w((E, N, Hd), N, Hd), "b1": np.zeros((E, Hd)),
                "W2": w((E, Hd, N), Hd, N), "b2": np.zeros((E, N))}

    params = attention_params(seed)
    for i in (4, 2):
        params.insert(i, moe())
    return params


def pads_claim_capacity():
    """A wrong MoE: pad tokens of the [B, T] mask claim expert capacity (the
    mask is not passed to the routing). Returns what undoes it."""
    from deeplearning4j_tpu_torch.nn.layers import moe

    real = moe.MixtureOfExpertsLayer.apply
    moe.MixtureOfExpertsLayer.apply = (
        lambda self, params, x, state, mask=None, **kw: real(self, params, x, state, **kw))
    return lambda: setattr(moe.MixtureOfExpertsLayer, "apply", real)


def moe_small_iterator():
    """The MoE block's text at ATTN_CPU_BUCKETS (4 sequences in each
    half), as the card-against-CPU comparison trains on it."""
    from deeplearning4j_tpu_torch import BucketingSequenceIterator

    lo, hi = ATTN_CPU_BUCKETS
    return BucketingSequenceIterator(attention_text(4, 4, lo // 2, lo, hi, SEED + 5),
                                     batch=ATTN_B, boundaries=ATTN_CPU_BUCKETS)


def moe_small_run(conf, host, dev, fault=False):
    """Two epochs of the MoE block over ``moe_small_iterator`` on ``dev``
    from ``host`` (with ``fault``, pad tokens claim capacity): (net,
    losses, params) as ``recipe_readings`` takes them."""
    import numpy as np

    from deeplearning4j_tpu_torch import MultiLayerNetwork, load_jax_params, params_to_numpy

    n = load_jax_params(MultiLayerNetwork(conf, device=dev), host)
    rec = LossRecorder()
    n.set_listeners(rec)
    undo = pads_claim_capacity() if fault else (lambda: None)
    try:
        n.fit(moe_small_iterator(), epochs=2)
    finally:
        undo()
    n.set_listeners()
    return n, np.array([float(l) for l in rec.losses]), params_to_numpy(n)


def phase_train_moe_attention(torch, dtype, card):
    """The long-context block whole (the attention net with the MoE): Adam
    at T <= 512 on the card and on the CPU, held by ``recipe_readings`` at
    MOE_TRAIN_LIMITS, and the same on the card with pad tokens claiming
    capacity, which must fail them; then at full width over
    BucketingSequenceIterator(4, (2048, 4096)) with exact launch counts,
    MOE_TIMED_EPOCHS timed epochs and the peak memory. Returns (launches,
    the timings, the param leaf shapes)."""
    import numpy as np

    from deeplearning4j_tpu_torch import (BucketingSequenceIterator, MultiLayerNetwork,
                                          load_jax_params, ops, params_to_numpy)

    conf = moe_attention_conf(dtype)
    host = moe_attention_params(SEED)
    runs = {dev: moe_small_run(conf, host, dev) for dev in ("cuda", "cpu")}
    readings = recipe_readings(runs["cuda"], runs["cpu"], host, lr=ATTN_LR)
    lim = MOE_TRAIN_LIMITS[dtype]
    within = within_limits(readings, lim)
    fault = recipe_readings(moe_small_run(conf, host, "cuda", fault=True), runs["cpu"], host,
                            lr=ATTN_LR)
    fault["caught"] = not within_limits(fault, lim)
    cpu_losses = runs["cpu"][1]
    loss_fall = float(cpu_losses[:2].mean() - cpu_losses[-2:].mean())
    del runs

    lo, hi = ATTN_BUCKETS
    it = BucketingSequenceIterator(attention_text(4, 4, lo // 2, lo, hi, SEED + 4),
                                   batch=ATTN_B, boundaries=ATTN_BUCKETS)
    shapes = [ds.features.shape[:2] for ds in it]
    if sorted(shapes) != [(ATTN_B, b) for b in ATTN_BUCKETS]:
        raise AssertionError(f"attention batches {shapes}")
    net = load_jax_params(MultiLayerNetwork(conf), host)
    rec = LossRecorder()
    net.set_listeners(rec)
    torch.cuda.synchronize()
    ops.reset_counters()
    net.fit(it)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.counters().items() if v}
    net.set_listeners()
    losses = np.array([float(l) for l in rec.losses])
    updates = len(shapes)
    expected = {"flash_attn_fwd": 2 * updates, "flash_attn_bwd_dq": 2 * updates,
                "flash_attn_bwd_dkv": 2 * updates, "softmax_xent_fwd": updates,
                "softmax_xent_bwd": updates, "adam_update": adam_launches(net) * updates}
    torch.cuda.reset_peak_memory_stats()
    epochs_s = []
    for _ in range(MOE_TIMED_EPOCHS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(it)
        torch.cuda.synchronize()
        epochs_s.append(time.perf_counter() - t0)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = statistics.median(epochs_s) * 1e3 / updates
    longest = next(ds for ds in it if ds.features.shape[1] == ATTN_BUCKETS[-1])
    prof = profile(torch, lambda: net.fit(longest), top=8, groups=MOE_PROFILE_GROUPS)
    # not gated on cpu_loss_fall: Adam's first steps move every element by
    # about lr, which at lr 3e-3 through the MoE's 1024-wide experts raises
    # the loss of the first updates (read on the CPU rehearsal); the card is
    # held to the CPU instead
    ok = (losses.shape == (updates,) and bool(np.isfinite(losses).all())
          and launches == expected and within and fault["caught"])
    emit("train_moe_attention", dtype=dtype, B=ATTN_B, n_out=ATTN_N, heads=ATTN_HEADS,
         experts=MOE_EXPERTS, hidden=MOE_HIDDEN, capacity_factor=MOE_CAPACITY,
         batches=[list(s) for s in shapes], losses=losses.tolist(),
         kernel_launches=launches, expected_launches=expected,
         compared_at=list(ATTN_CPU_BUCKETS), cpu_losses=cpu_losses.tolist(),
         cpu_loss_fall=loss_fall, readings_vs_cpu=readings, limits=lim,
         fault_pads_claim_capacity_vs_cpu=fault, timed_epoch_s_runs=epochs_s,
         ms_per_update=ms, peak_gib=peak_gib,
         profile_T4096_update={k: prof[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                                    "top_kernels", "groups")},
         real_tokens_per_s=sum(len(x) for x, _ in it.sequences) / (ms * updates / 1e3),
         ok=ok, gpu=card)
    if not ok:
        raise AssertionError(f"MoE attention training {dtype} failed its checks")
    leaf_shapes = [np.shape(p[k]) for p in params_to_numpy(net) for k in p]
    del net
    torch.cuda.empty_cache()
    return launches, {"ms_per_update": ms, "peak_gib": peak_gib}, leaf_shapes


def adam_check(torch, ad, name, leaves, sc, want_launches=1):
    """Row 12 on ``leaves`` (one grouped call) against its plain version leaf
    by leaf: each output's max |err| over its max |ref| at ADAM_REL, and the
    call's launches. Returns the max abs error."""
    gs, ms, vs = (list(x) for x in zip(*leaves))
    before = ad.launches["adam_update"]
    got = ad.fused_adam_update_leaves(gs, ms, vs, *sc)
    launched = ad.launches["adam_update"] - before
    rel, abs_err = dict.fromkeys(("u", "m", "v"), 0.0), 0.0
    for i, (g, m, v) in enumerate(leaves):
        want = ad.adam_update_reference(g, m, v, *sc)
        for n, a, b in zip(rel, (got[0][i], got[1][i], got[2][i]), want):
            if a.shape != b.shape:
                raise AssertionError(f"adam_update {name} leaf {i}: {a.shape}, {b.shape}")
            err = float((a - b).abs().max())
            abs_err = max(abs_err, err)
            rel[n] = max(rel[n], err / float(b.abs().max()))
    torch.cuda.synchronize()
    check("adam_update", "float32", rel, dict.fromkeys(rel, ADAM_REL), case=name,
          leaves=len(leaves), elements=sum(g.numel() for g in gs), max_abs_err=abs_err,
          launches=launched, relative_to_largest=True)
    if launched != want_launches:
        raise AssertionError(f"adam_update {name}: {launched} launches, not {want_launches}")
    return abs_err


def kernels_slice18(torch, ls, sx, ad, card, seq_mask, leaf_shapes):
    """The kernels of slice 18's paths at the shapes those paths give them
    that no earlier phase holds, against their plain versions, then timed
    beside them, their bounds and the library call: rows 6-7 and dRW at a
    TBPTT segment (T=50, B=64, H=512), rows 10-11 at its N = B*50 rows; rows
    8-9 and dRW at the classifier's long batch with its mask; rows 10-11 at
    the classifier's head (N=64, C=96); row 12 at the classifier's and the
    MoE net's leaves. Returns {(path, kernel): (max abs err, times)}."""
    import numpy as np

    out = {}
    seg = f"T={TBPTT} B={BATCH} H={HIDDEN} (a TBPTT segment)"
    for k, (err, t) in lstm_rows_at(torch, ls, TBPTT, BATCH, HIDDEN, card,
                                    "graph_char_rnn").items():
        out[("graph_char_rnn", k)] = (err, t, seg + (f" R={TBPTT * BATCH}"
                                                     if k == "drw_product" else ""))
    mask = torch.as_tensor(seq_mask, device=DEVICE).contiguous()
    seq = f"T={STEPS} B={BATCH} H={HIDDEN}, the long batch's mask"
    for k, (err, t) in lstm_rows_at(torch, ls, STEPS, BATCH, HIDDEN, card, "seq_classifier",
                                    mask=mask).items():
        out[("seq_classifier", k)] = (err, t, seq + (f" R={STEPS * BATCH}"
                                                     if k == "drw_product" else ""))
    for path, (N, C) in (("graph_char_rnn", (BATCH * TBPTT, VOCAB)),
                         ("seq_classifier", (BATCH, VOCAB))):
        e = sxent_case(torch, sx, N, C, "float32", "one_hot", SEED + N)
        for (k, _), t in time_sxent(torch, sx, N, C, ("float32",), card,
                                    f"{path}'s loss head").items():
            err = e["loss"] if k.endswith("fwd") else max(e["dx"], e["dl"])
            out[(path, k)] = (err, t, f"N={N} C={C}")
    _, sc = adam_inputs(torch, SEED)
    for i, (path, shapes) in enumerate(leaf_shapes.items()):
        leaves, _ = adam_inputs(torch, SEED + 40 + i, shapes)
        err = adam_check(torch, ad, path, leaves, sc)
        out[(path, "adam_update")] = (err, time_adam(
            torch, ad, card, shapes, f"{path}'s {len(shapes)} leaves"), f"{len(shapes)} leaves")
    return out


# ---- slice 19: pretraining and transfer learning. The DBN at dbn_conf()'s
# defaults (784-500-250-100-10, binary units, CD-1) with Adam at its lr
# 1e-2, B=128, on synthetic binary 784-wide images (MNIST needs a download):
# DBN_CLASSES prototypes from the seed, each image one of them with
# DBN_FLIP of its pixels flipped. Each RBM pretrains on DBN_PRETRAIN_BATCHES
# batches (one epoch), then DBN_FINETUNE_UPDATES fine-tune updates. The
# Bernoulli draws come through pretrain's noise seam, drawn on the host
# from the seed, so the card and the CPU sample alike.
DBN_B, DBN_CLASSES, DBN_FLIP = 128, 10, 0.1
DBN_PRETRAIN_BATCHES, DBN_FINETUNE_UPDATES = 4, 4
DBN_TIMED = {"warmup": 1, "timed": 5}
# examples/dbn_pretrain.py's DBN on the bundled digits: its conf, its
# quick run's epochs (2 pretrain, 12 fine-tune) and tests/test_examples.py's
# pin. The JAX package's own run of the example (main(quick=True), on the
# CPU, x64 off) scores 0.8222 (PERF.md, section 6); the port's on the CPU
# 0.8361; the card draws its own noise.
DBN_DIGITS = dict(n_in=64, layer_sizes=(96, 48), n_classes=10, visible_unit="gaussian",
                  updater="adam", learning_rate=2e-3, seed=5)
DBN_DIGITS_EPOCHS = (2, 12)
DBN_DIGITS_PIN = 0.7
# the VAE at dl4j-examples' VariationalAutoEncoderExample widths (MNIST:
# encoder 256-256, decoder 256-256, latent 2, leaky relu, Bernoulli
# reconstruction) under a 10-way center-loss softmax head, Adam at 1e-3,
# B=128 on the DBN's images; eps through the seam, drawn on the host
VAE_LR, VAE_PRETRAIN_BATCHES, VAE_FIT_UPDATES = 1e-3, 4, 4
# the ResNet-50 transfer: the conf at B=128, f32, its feature extractor
# frozen through "avgpool" (with a BN state that is not the initial one),
# "out" replaced by a 10-way softmax head, Adam at 1e-3; TRANSFER_UPDATES
# per-batch updates over as many batches, then the same batches staged in
# windows of TRANSFER_STAGE
TRANSFER_CLASSES, TRANSFER_LR, TRANSFER_UPDATES, TRANSFER_STAGE = 10, 1e-3, 4, 2
TRANSFER_FAULTS = ("frozen_params_move", "frozen_bn_in_train_mode")
# examples/early_stopping.py's MLP and data (8 train batches of 32, 4 score
# batches), its full run's conditions, on the card and the CPU from the
# same weights with LocalFileModelSaver
ES_MAX_EPOCHS, ES_PATIENCE, ES_SCORE_REL = 30, 5, 1e-5
# the card against the CPU from the same weights and noise. The pretrain
# losses (free-energy differences, CD's surrogate; the negative ELBO) are
# held relative to their mean size; params by each tensor's change against
# the CPU's (relative to its norm), the largest difference and the count of
# elements more than lr/10 apart (Adam's step is about lr wherever a
# gradient sits near 0). Set from scripts/dbn_vae_sensitivity.py (CPU, 6
# starts each moved by one rounding): the DBN reads at most loss 5.1e-7,
# change 1.5e-5, max 1.2e-4 (lr 1e-2), 0 elements; the VAE 1.2e-7, 7.5e-5,
# 6.0e-5 (lr 1e-3), 0. Wrong: the RBM's negative phase with the wrong sign
# reads 284, 3.26, 0.080, 544,044 elements in pretrain (0.12, 1.16, 0.14,
# 543,694 after the fit); the VAE without its KL term 3.0e-3, 2.98,
# 7.9e-3, 449,361 (0.46, 14.6, 0.014, 457,347). An RBM unit the card
# samples otherwise (u within a rounding of p) can move an element by
# about lr an update, so the largest difference is held at 4 lr only.
DBN_LIMITS = dict.fromkeys(("pretrain", "finetune"), {
    "loss_rel": 1e-4, "change_rel": 1e-2, "max_param_abs": 4e-2,
    "elements_over_lr_tenth": 1000})
VAE_LIMITS = dict.fromkeys(("pretrain", "finetune"), {
    "loss_rel": 1e-4, "change_rel": 1e-2, "max_param_abs": 4e-3,
    "elements_over_lr_tenth": 1000})
# rows 10-12 of slice 19's paths: the main path's row whose shape a path's
# row has (rows 10-11 at N=128, C=10: slice 16's digits head), or None:
# held and timed at the path's own shape (kernels_slice19)
SXENT_AT_DIGITS = {"softmax_xent_fwd": "softmax_xent_fwd@digits",
                   "softmax_xent_bwd": "softmax_xent_bwd@digits"}
SLICE19_ROWS = {
    "dbn_pretrain": {"adam_update": None},
    "dbn": {**SXENT_AT_DIGITS, "adam_update": None},
    "dbn_digits": {**SXENT_AT_DIGITS, "adam_update": None},
    "vae": {**SXENT_AT_DIGITS, "adam_update": None},
    "resnet50_transfer": {**SXENT_AT_DIGITS, "adam_update": None},
    "early_stopping": {"softmax_xent_fwd": None, "softmax_xent_bwd": None, "adam_update": None},
}


def dbn_batches(n, seed):
    """``n`` (x, y) batches of DBN_B binary 784-wide images and one-hot
    labels of DBN_CLASSES prototypes, from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    protos = np.random.default_rng(SEED + 49).integers(0, 2, (DBN_CLASSES, 784))
    out = []
    for _ in range(n):
        idx = rng.integers(0, DBN_CLASSES, DBN_B)
        flip = rng.uniform(size=(DBN_B, 784)) < DBN_FLIP
        out.append((np.abs(protos[idx] - flip).astype(np.float32), one_hot(idx, DBN_CLASSES)))
    return out


def rbm_draws(conf, batches: int, seed):
    """The uniforms of pretrain's Bernoulli draws, one entry per pretrain
    batch in pretrain's order (layer by layer, batch by batch): the keyword
    arguments of ``RBM.pretrain_loss``, host f32 arrays ([(u_h, u_v)] for
    CD-1)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    widths = [conf.input_type.flat_size()] + [l.n_out for l in conf.layers]
    out = []
    for i, layer in enumerate(conf.layers):
        if layer.is_pretrain_layer:
            for _ in range(batches):
                out.append({"uniforms": [
                    (rng.uniform(size=(DBN_B, widths[i + 1])).astype(np.float32),
                     rng.uniform(size=(DBN_B, widths[i])).astype(np.float32))
                    for _ in range(layer.k)]})
    return out


def vae_draws(layer, batches: int, seed):
    """eps of each VAE pretrain batch, [num_samples, B, n_out] host f32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [{"eps": rng.normal(size=(layer.num_samples, DBN_B, layer.n_out)).astype(np.float32)}
            for _ in range(batches)]


class SeamNoise:
    """``pretrain``'s noise seam fed with host draws (one entry a batch, in
    order), moved to the net's device. pretrain keeps only its last loss
    (``_last_loss``), so each call also keeps the loss of the batch before
    it; ``losses()`` adds the last."""

    def __init__(self, net, draws):
        self.net, self.draws, self.kept = net, iter(draws), []

    def _to(self, a):
        import torch

        if isinstance(a, (list, tuple)):
            return [self._to(v) for v in a]
        return torch.as_tensor(a, device=self.net.device)

    def __call__(self, idx, layer, h):
        if self.net._last_loss is not None:
            self.kept.append(float(self.net._last_loss))
        return {k: self._to(v) for k, v in next(self.draws).items()}

    def losses(self):
        import numpy as np

        return np.array(self.kept + [float(self.net._last_loss)])


def pretrain_faults(fault):
    """Install a wrong pretrain loss (None: none): the RBM's negative phase
    with the wrong sign (mean FE(v_data) + mean FE(v_model)), or the VAE's
    ELBO without its KL term. Returns the undo."""
    import torch

    from deeplearning4j_tpu_torch import RBM, VariationalAutoencoder

    real_rbm, real_vae = RBM.pretrain_loss, VariationalAutoencoder.pretrain_loss

    def rbm_sign(self, params, x, **kw):  # A - B -> A + B = 2A - (A - B)
        return 2 * torch.mean(self.free_energy(params, x)) - real_rbm(self, params, x, **kw)

    def vae_no_kl(self, params, x, **kw):
        mean, log_var = self.encode(params, x)
        kl = -0.5 * torch.sum(1 + log_var - mean ** 2 - torch.exp(log_var), dim=-1)
        return real_vae(self, params, x, **kw) - torch.mean(kl)

    if fault == "rbm_negative_phase_sign":
        RBM.pretrain_loss = rbm_sign
    elif fault == "vae_kl_dropped":
        VariationalAutoencoder.pretrain_loss = vae_no_kl

    def undo():
        RBM.pretrain_loss, VariationalAutoencoder.pretrain_loss = real_rbm, real_vae
    return undo


def pretrain_run(conf, host, pre, fine, draws, dev, fault=None):
    """From ``host``'s params on ``dev`` under ``fault``: ``pretrain`` over
    the ``pre`` batches (one epoch, noise from ``draws``), then one ``fit``
    of each ``fine`` batch. Returns (the net, the pretrain losses, the
    params after pretrain, the fit losses, the params after, launches of
    pretrain, launches of the fits; launches on the card only)."""
    import numpy as np
    import torch

    from deeplearning4j_tpu_torch import (DataSet, MultiLayerNetwork, load_jax_params, ops,
                                          params_to_numpy)

    net = load_jax_params(MultiLayerNetwork(conf, device=dev), host)
    noise = SeamNoise(net, draws)
    card = dev == "cuda"
    undo = pretrain_faults(fault)
    try:
        if card:
            torch.cuda.synchronize()
        ops.reset_counters()
        net.pretrain([DataSet(x, y) for x, y in pre], noise=noise)
        if card:
            torch.cuda.synchronize()
        pre_launches = {k: v for k, v in ops.counters().items() if v} if card else None
        pre_losses, pretrained = noise.losses(), params_to_numpy(net)
        rec = LossRecorder()
        net.set_listeners(rec)
        ops.reset_counters()
        for b in fine:
            net.fit(b)
        if card:
            torch.cuda.synchronize()
        fit_launches = {k: v for k, v in ops.counters().items() if v} if card else None
        net.set_listeners()
    finally:
        undo()
    return dict(net=net, start=host, pre_losses=pre_losses, pretrained=pretrained,
                fit_losses=np.array([float(l) for l in rec.losses]),
                params=params_to_numpy(net), pre_launches=pre_launches,
                fit_launches=fit_launches)


def change_readings(losses, params, start, ref_losses, ref_params, ref_start, lr) -> dict:
    """Card against CPU: the largest |loss - ref| over the mean |ref loss|
    (a CD surrogate can cross zero); each tensor's change from its run's
    ``start`` against the ref's change from ``ref_start``, the norm of the
    difference over the norm of the ref's change (a tensor that the ref
    left as it was must stay too, else it reads inf); the largest param
    difference; the elements more than lr/10 apart."""
    import numpy as np

    diffs, rel = [], []
    for p, s, q, s_ref in zip(params, start, ref_params, ref_start):
        for k in q:
            diffs.append(np.abs(p[k] - q[k]))
            mine = p[k] - np.asarray(s[k], np.float32)
            theirs = q[k] - np.asarray(s_ref[k], np.float32)
            gap, ref_change = float(np.linalg.norm(mine - theirs)), float(np.linalg.norm(theirs))
            rel.append(gap / ref_change if ref_change else (0.0 if gap == 0.0 else np.inf))
    return {"loss_rel": float(np.max(np.abs(losses - ref_losses)) / np.mean(np.abs(ref_losses))),
            "change_rel": max(rel), "max_param_abs": max(float(d.max()) for d in diffs),
            "elements_over_lr_tenth": int(sum(int((d > lr / 10).sum()) for d in diffs))}


def pretrain_readings(run, ref, lr) -> dict:
    """``change_readings`` of pretrain (each run from its seed params) and
    of the fits (each from its own pretrained params)."""
    return {"pretrain": change_readings(run["pre_losses"], run["pretrained"], run["start"],
                                        ref["pre_losses"], ref["pretrained"], ref["start"], lr),
            "finetune": change_readings(run["fit_losses"], run["params"], run["pretrained"],
                                        ref["fit_losses"], ref["params"], ref["pretrained"], lr)}


def within_both(readings, limits) -> bool:
    return all(within_limits(readings[part], limits[part]) for part in limits)


def pretrain_ms(torch, net, idx, batches, reps=2) -> float:
    """ms per update of ``pretrain_layer(idx)`` over ``batches`` (the
    network's generator draws the noise), the lesser of ``reps`` runs."""
    from deeplearning4j_tpu_torch import DataSet

    data = [DataSet(x, y) for x, y in batches]
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.pretrain_layer(idx, data)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3 / len(batches))
    return min(runs)


def phase_train_dbn(torch, card):
    """The DBN at full width: pretrain (each RBM DBN_PRETRAIN_BATCHES
    updates, the uniforms through the seam), then DBN_FINETUNE_UPDATES
    fine-tune updates, on the card and on the CPU from the same weights and
    draws, held by ``pretrain_readings`` at DBN_LIMITS; the CPU's fine-tune
    loss must fall; exact launches (pretrain: one Adam launch an update and
    nothing else; fine-tune: one softmax-xent forward and backward and the
    Adam launches an update); the RBM with its negative phase's sign wrong
    must fail the limits. Then ms per pretrain update of each RBM and per
    fine-tune update. Returns (launches by path, times, leaf shapes by
    path)."""
    import numpy as np

    from deeplearning4j_tpu_torch import dbn_conf

    conf = dbn_conf(updater="adam")
    lr = conf.updater["learning_rate"]
    host = conf_host(conf)
    pre = dbn_batches(DBN_PRETRAIN_BATCHES, SEED + 50)
    fine = dbn_batches(DBN_FINETUNE_UPDATES, SEED + 51)
    draws = rbm_draws(conf, DBN_PRETRAIN_BATCHES, SEED + 52)
    t0 = time.perf_counter()
    card_run = pretrain_run(conf, host, pre, fine, draws, "cuda")
    cpu_run = pretrain_run(conf, host, pre, fine, draws, "cpu")
    readings = pretrain_readings(card_run, cpu_run, lr)
    fault = pretrain_readings(pretrain_run(conf, host, pre, fine, draws, "cuda",
                                           "rbm_negative_phase_sign"), cpu_run, lr)
    fault["caught"] = not within_both(fault, DBN_LIMITS)
    compared_s = time.perf_counter() - t0
    net = card_run["net"]
    n_rbm = len(conf.layers) - 1
    pre_expected = {"adam_update": n_rbm * DBN_PRETRAIN_BATCHES}
    fit_expected = {"softmax_xent_fwd": DBN_FINETUNE_UPDATES,
                    "softmax_xent_bwd": DBN_FINETUNE_UPDATES,
                    "adam_update": DBN_FINETUNE_UPDATES * adam_launches(net)}
    rbm_ms = [pretrain_ms(torch, net, i, pre) for i in range(n_rbm)]
    times, timed_launches, losses = timed_fit(torch, net, fine[0], **DBN_TIMED)
    ms = statistics.median(times)
    cpu_fit = cpu_run["fit_losses"]
    ok = (within_both(readings, DBN_LIMITS) and fault["caught"]
          and card_run["pre_launches"] == pre_expected
          and card_run["fit_launches"] == fit_expected and cpu_fit[-1] < cpu_fit[0]
          and bool(np.isfinite(losses).all()))
    emit("train_dbn", B=DBN_B, widths=[784, *(l.n_out for l in conf.layers)],
         params=sum(v.size for p in host for v in p.values()),
         pretrain_batches_per_rbm=DBN_PRETRAIN_BATCHES, finetune_updates=DBN_FINETUNE_UPDATES,
         card_pretrain_losses=card_run["pre_losses"].tolist(),
         cpu_pretrain_losses=cpu_run["pre_losses"].tolist(),
         card_finetune_losses=card_run["fit_losses"].tolist(), cpu_finetune_losses=cpu_fit.tolist(),
         readings_vs_cpu=readings, limits=DBN_LIMITS, fault_rbm_negative_phase_sign=fault,
         compared_s=compared_s, pretrain_launches=card_run["pre_launches"],
         pretrain_expected=pre_expected, finetune_launches=card_run["fit_launches"],
         finetune_expected=fit_expected, pretrain_ms_per_update_by_rbm=rbm_ms,
         finetune_update_ms_runs=times, finetune_ms_per_update=ms, ok=ok, gpu=card)
    if not ok:
        raise AssertionError("DBN training failed its checks")
    shapes = {"dbn_pretrain": [np.shape(host[0][k]) for k in sorted(host[0])],
              "dbn": [np.shape(p[k]) for p in host for k in sorted(p)]}
    launches = {"dbn_pretrain": card_run["pre_launches"],
                "dbn": sum_counts([card_run["fit_launches"], timed_launches])}
    return launches, {"pretrain_ms_per_update_by_rbm": rbm_ms,
                      "finetune_ms_per_update": ms}, shapes


def phase_train_dbn_digits(torch, card):
    """examples/dbn_pretrain.py on the card: its DBN (64-96-48-10, Gaussian
    visible units, Adam 2e-3, seed 5) pretrained 2 epochs and fine-tuned
    12 over DigitsDataSetIterator (batches of 128, flat), then evaluated on
    the 360 held out: above DBN_DIGITS_PIN (tests/test_examples.py's pin),
    with exact launches. Returns (launches, accuracy, ms, leaf shapes)."""
    import numpy as np

    from deeplearning4j_tpu_torch import (DigitsDataSetIterator, MultiLayerNetwork, dbn_conf,
                                          load_jax_params, ops)

    conf = dbn_conf(**DBN_DIGITS)
    host = conf_host(conf)
    net = load_jax_params(MultiLayerNetwork(conf), host)
    it = DigitsDataSetIterator(batch=128, train=True, flat=True)
    pre_epochs, fit_epochs = DBN_DIGITS_EPOCHS
    torch.cuda.synchronize()
    ops.reset_counters()
    t0 = time.perf_counter()
    net.pretrain(it, epochs=pre_epochs)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    rec = LossRecorder()
    net.set_listeners(rec)
    t0 = time.perf_counter()
    net.fit(it, epochs=fit_epochs)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    ev = net.evaluate(DigitsDataSetIterator(batch=120, train=False, shuffle=False, flat=True))
    launches = {k: v for k, v in ops.counters().items() if v}
    net.set_listeners()
    n_rbm, batches = len(conf.layers) - 1, len(it)
    updates = fit_epochs * batches
    expected = {"adam_update": n_rbm * pre_epochs * batches + updates * adam_launches(net),
                "softmax_xent_fwd": updates, "softmax_xent_bwd": updates}
    losses = np.array([float(l) for l in rec.losses])
    acc = ev.accuracy()
    ok = (acc > DBN_DIGITS_PIN and launches == expected and len(losses) == updates
          and bool(np.isfinite(losses).all()))
    emit("train_dbn_digits", conf=DBN_DIGITS, epochs=list(DBN_DIGITS_EPOCHS), batches=batches,
         accuracy=acc, pin=DBN_DIGITS_PIN, examples=ev.examples, first_loss=float(losses[0]),
         last_loss=float(losses[-1]), kernel_launches=launches, expected_launches=expected,
         pretrain_ms_per_update=pre_s * 1e3 / (n_rbm * pre_epochs * batches),
         finetune_ms_per_update=fit_s * 1e3 / updates, ok=ok, gpu=card)
    if not ok:
        raise AssertionError("the digits DBN failed its checks")
    return launches, acc, fit_s * 1e3 / updates, [np.shape(p[k]) for p in host for k in sorted(p)]


def vae_conf():
    """The VAE (VariationalAutoEncoderExample's widths) under a 10-way
    center-loss softmax head."""
    from deeplearning4j_tpu_torch import (BernoulliReconstruction, CenterLossOutputLayer,
                                          InputType, MultiLayerConfiguration, UpdaterConfig,
                                          VariationalAutoencoder)

    return MultiLayerConfiguration(
        layers=[VariationalAutoencoder(n_out=2, encoder_layer_sizes=(256, 256),
                                       decoder_layer_sizes=(256, 256), activation="leakyrelu",
                                       reconstruction=BernoulliReconstruction()),
                CenterLossOutputLayer(n_out=DBN_CLASSES, activation="softmax", loss="mcxent",
                                      lambda_=1e-2)],
        input_type=InputType.feed_forward(784),
        updater=UpdaterConfig(updater="adam", learning_rate=VAE_LR), seed=SEED + 55)


def phase_pretrain_vae(torch, card):
    """The VAE pretrained alone (VAE_PRETRAIN_BATCHES updates, eps through
    the seam), then VAE_FIT_UPDATES ``fit`` updates of the whole net under
    its center-loss head, on the card and the CPU from the same weights and
    eps, held at VAE_LIMITS; the ELBO without its KL term must fail them;
    exact launches (pretrain: Adam alone; fit: softmax-xent forward and
    backward through CenterLossOutputLayer's primary loss, and Adam). Then
    ms per pretrain and per fit update. Returns (launches, times, leaf
    shapes)."""
    import numpy as np

    conf = vae_conf()
    host = conf_host(conf)
    pre = dbn_batches(VAE_PRETRAIN_BATCHES, SEED + 56)
    fine = dbn_batches(VAE_FIT_UPDATES, SEED + 57)
    draws = vae_draws(conf.layers[0], VAE_PRETRAIN_BATCHES, SEED + 58)
    card_run = pretrain_run(conf, host, pre, fine, draws, "cuda")
    cpu_run = pretrain_run(conf, host, pre, fine, draws, "cpu")
    readings = pretrain_readings(card_run, cpu_run, VAE_LR)
    fault = pretrain_readings(pretrain_run(conf, host, pre, fine, draws, "cuda",
                                           "vae_kl_dropped"), cpu_run, VAE_LR)
    fault["caught"] = not within_both(fault, VAE_LIMITS)
    net = card_run["net"]
    pre_expected = {"adam_update": VAE_PRETRAIN_BATCHES}
    fit_expected = {"softmax_xent_fwd": VAE_FIT_UPDATES, "softmax_xent_bwd": VAE_FIT_UPDATES,
                    "adam_update": VAE_FIT_UPDATES * adam_launches(net)}
    pre_ms = pretrain_ms(torch, net, 0, pre)
    times, timed_launches, losses = timed_fit(torch, net, fine[0], **DBN_TIMED)
    ms = statistics.median(times)
    cpu_pre = cpu_run["pre_losses"]
    ok = (within_both(readings, VAE_LIMITS) and fault["caught"]
          and card_run["pre_launches"] == pre_expected
          and card_run["fit_launches"] == fit_expected and cpu_pre[-1] < cpu_pre[0]
          and bool(np.isfinite(losses).all()))
    emit("pretrain_vae", B=DBN_B, params=sum(v.size for p in host for v in p.values()),
         card_pretrain_losses=card_run["pre_losses"].tolist(), cpu_pretrain_losses=cpu_pre.tolist(),
         card_fit_losses=card_run["fit_losses"].tolist(),
         cpu_fit_losses=cpu_run["fit_losses"].tolist(), readings_vs_cpu=readings,
         limits=VAE_LIMITS, fault_vae_kl_dropped=fault, pretrain_launches=card_run["pre_launches"],
         pretrain_expected=pre_expected, fit_launches=card_run["fit_launches"],
         fit_expected=fit_expected, pretrain_ms_per_update=pre_ms, fit_update_ms_runs=times,
         fit_ms_per_update=ms, ok=ok, gpu=card)
    if not ok:
        raise AssertionError("VAE pretraining failed its checks")
    launches = sum_counts([card_run["pre_launches"], card_run["fit_launches"], timed_launches])
    return launches, {"pretrain_ms_per_update": pre_ms, "fit_ms_per_update": ms}, [
        np.shape(p[k]) for p in host for k in sorted(p)]


def transfer_faults(fault):
    """Install a wrong FrozenLayer (None: none): its params not detached,
    so they move, or its layer run in training mode, so BatchNormalization
    normalizes by the batch and updates its statistics. Returns the undo."""
    from deeplearning4j_tpu_torch import FrozenLayer

    real = FrozenLayer.apply

    def moves(self, params, x, state, *, mask=None, train=False, generator=None, **kw):
        return self.layer.apply(params, x, state, mask=mask, train=False, generator=generator,
                                **kw)

    def bn_train(self, params, x, state, *, mask=None, train=False, generator=None, **kw):
        return self.layer.apply({k: v.detach() for k, v in params.items()}, x, state, mask=mask,
                                train=train, generator=generator, **kw)

    if fault == "frozen_params_move":
        FrozenLayer.apply = moves
    elif fault == "frozen_bn_in_train_mode":
        FrozenLayer.apply = bn_train

    def undo():
        FrozenLayer.apply = real
    return undo


def transferred(base):
    """ResNet-50 transferred: frozen through "avgpool", "out" replaced by a
    TRANSFER_CLASSES-way softmax head on "avgpool", Adam at TRANSFER_LR."""
    from deeplearning4j_tpu_torch import (FineTuneConfiguration, OutputLayer, TransferLearning,
                                          UpdaterConfig)

    return (TransferLearning.GraphBuilder(base)
            .fine_tune_configuration(FineTuneConfiguration(
                updater=UpdaterConfig(updater="adam", learning_rate=TRANSFER_LR)))
            .set_feature_extractor("avgpool")
            .remove_vertex_and_connections("out")
            .add_layer("head", OutputLayer(n_out=TRANSFER_CLASSES, activation="softmax",
                                           loss="mcxent"), "avgpool")
            .set_outputs("head").build())


def frozen_moved(net, before, state_before) -> dict:
    """The largest change of any frozen param and of any BN statistic from
    ``before`` (0.0: bit for bit unchanged)."""
    import numpy as np

    from deeplearning4j_tpu_torch import params_to_numpy, state_to_numpy

    params, state = params_to_numpy(net), state_to_numpy(net)
    return {"frozen_param_max_abs": max(float(np.abs(params[n][k] - v).max())
                                        for n, p in before.items() if n != "head"
                                        for k, v in p.items()),
            "bn_state_max_abs": max(float(np.abs(state[n][k] - v).max())
                                    for n, s in state_before.items() for k, v in s.items())}


def phase_transfer_resnet50(torch, host, state, full_ms, card):
    """ResNet-50 transferred at full width (f32, B=128): TRANSFER_UPDATES
    per-batch updates, then the same batches through ``fit(stage_on_device
    =TRANSFER_STAGE)`` on a fresh transfer: every frozen param and BN
    statistic bit for bit unchanged in both; the head held against a CPU
    Adam update of a lone head on the pooled features the card computed,
    copied to the host (MNIST_LIMITS); the staged head against the
    per-batch one; exact launches per update; each of TRANSFER_FAULTS
    caught in one update. Then ms per update (per batch, staged), beside
    the full ResNet-50 f32 update of this run (``full_ms``) and one
    ``output()``; the peak memory; one profiled update. Returns (launches,
    times, leaf shapes)."""
    import numpy as np

    from deeplearning4j_tpu_torch import (InputType, MultiLayerConfiguration, MultiLayerNetwork,
                                          OutputLayer, UpdaterConfig, load_jax_params, ops,
                                          params_to_numpy, resnet50_conf, state_to_numpy)

    torch.cuda.empty_cache()
    base = resnet_net(resnet50_conf(), host, state)
    rng = np.random.default_rng(SEED + 60)
    batches = [(alexnet_images(RES_B, SEED + 61 + i)[0],
                one_hot(rng.integers(0, TRANSFER_CLASSES, RES_B), TRANSFER_CLASSES))
               for i in range(TRANSFER_UPDATES)]
    net = transferred(base)
    before, state_before = params_to_numpy(net), state_to_numpy(net)
    head0 = before["head"]
    with torch.no_grad():  # the pooled features the frozen backbone gives each batch
        feats = [net._activations(net._params(), [net._input(x)])[0]["avgpool"].cpu().numpy()
                 for x, _ in batches]
    rec = LossRecorder()
    net.set_listeners(rec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counters()
    for b in batches:
        net.fit(b)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.counters().items() if v}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    net.set_listeners()
    per_batch = frozen_moved(net, before, state_before)
    card_losses = np.array([float(l) for l in rec.losses])
    card_head = params_to_numpy(net)["head"]

    head_conf = MultiLayerConfiguration(
        layers=[OutputLayer(n_out=TRANSFER_CLASSES, activation="softmax", loss="mcxent")],
        input_type=InputType.feed_forward(feats[0].shape[1]),
        updater=UpdaterConfig(updater="adam", learning_rate=TRANSFER_LR))
    cpu = load_jax_params(MultiLayerNetwork(head_conf, device="cpu"), [head0])
    cpu_rec = LossRecorder()
    cpu.set_listeners(cpu_rec)
    for f, (_, y) in zip(feats, batches):
        cpu.fit((f, y))
    cpu_run = (cpu, np.array([float(l) for l in cpu_rec.losses]), params_to_numpy(cpu))
    readings = recipe_readings((net, card_losses, [card_head]), cpu_run, [head0],
                               lr=TRANSFER_LR)

    staged = transferred(base)
    torch.cuda.synchronize()
    ops.reset_counters()
    staged.fit(batches, stage_on_device=TRANSFER_STAGE)
    torch.cuda.synchronize()
    staged_launches = {k: v for k, v in ops.counters().items() if v}
    staged_moved = frozen_moved(staged, before, state_before)
    staged_head = params_to_numpy(staged)["head"]
    staged_vs_eager = max(float(np.abs(staged_head[k] - card_head[k]).max()) for k in card_head)
    staged_replays, staged_steps = staged._step_graphs.replays, staged.staged_steps_total

    faults = {}
    for fault in TRANSFER_FAULTS:
        wrong = transferred(base)
        undo = transfer_faults(fault)
        try:
            wrong.fit(batches[0])
        finally:
            undo()
        faults[fault] = frozen_moved(wrong, before, state_before)
        faults[fault]["caught"] = any(v > 0.0 for v in faults[fault].values())
        del wrong
        torch.cuda.empty_cache()

    times, timed_launches, losses = timed_fit(torch, net, batches[0], warmup=1, timed=5)
    ms = statistics.median(times)
    x0 = batches[0][0]
    out_runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        net.output(x0)
        out_runs.append((time.perf_counter() - t0) * 1e3)
    staged_runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        staged.fit(batches, stage_on_device=TRANSFER_STAGE)
        torch.cuda.synchronize()
        staged_runs.append((time.perf_counter() - t0) * 1e3 / len(batches))
    on_card = tuple(torch.as_tensor(a, device=DEVICE) for a in batches[0])
    prof = profile(torch, lambda: net.fit(on_card), top=10, groups=RES_PROFILE_GROUPS)
    emit("profile", what=f"fit() one Adam update of the transferred ResNet-50 (frozen through "
         f"avgpool), f32 B={RES_B}, batch on the card", gpu=card, **prof)
    per_update = {"softmax_xent_fwd": 1, "softmax_xent_bwd": 1,
                  "adam_update": adam_launches(net)}
    expected = {k: v * TRANSFER_UPDATES for k, v in per_update.items()}
    unchanged = all(v == 0.0 for v in (*per_batch.values(), *staged_moved.values()))
    ok = (unchanged and within_limits(readings, MNIST_LIMITS)
          and all(f["caught"] for f in faults.values()) and launches == expected
          and staged_launches.get("softmax_xent_fwd", 0) > 0
          and staged_steps == len(batches)
          and staged_replays == len(batches)
          and within_limits({"staged_head_vs_per_batch": staged_vs_eager},
                            {"staged_head_vs_per_batch": MNIST_LIMITS["max_param_abs"]})
          and bool(np.isfinite(losses).all()))
    emit("transfer_resnet50", B=RES_B, classes=TRANSFER_CLASSES, lr=TRANSFER_LR,
         updates=TRANSFER_UPDATES, frozen_vertices=sum(
             1 for v in net.conf.vertices.values()
             if type(getattr(v, "layer", None)).__name__ == "FrozenLayer"),
         param_leaves=sum(len(p) for p in net._leaves()),
         per_batch_moved=per_batch, staged_moved=staged_moved, card_losses=card_losses.tolist(),
         cpu_head_losses=cpu_run[1].tolist(), head_readings_vs_cpu=readings,
         limits=MNIST_LIMITS, staged_head_vs_per_batch_max_abs=staged_vs_eager,
         staged_steps=staged_steps, staged_replays=staged_replays,
         faults=faults, kernel_launches=launches, expected_launches=expected,
         staged_launches=staged_launches, update_ms_runs=times, ms_per_update=ms,
         staged_ms_per_update_runs=staged_runs, staged_ms_per_update=min(staged_runs),
         output_ms_runs=out_runs, output_ms_median=statistics.median(out_runs),
         full_resnet50_f32_ms_per_update=full_ms, peak_allocated_gib=peak_gib,
         idle_share=prof["idle_share"], ok=ok, gpu=card)
    if not ok:
        raise AssertionError("the ResNet-50 transfer failed its checks")
    shapes = [np.shape(p[k]) for _, p in sorted(before.items()) for k in sorted(p)]
    del net, staged, base
    torch.cuda.empty_cache()
    return (sum_counts([launches, staged_launches, timed_launches]),
            {"ms_per_update": ms, "staged_ms_per_update": min(staged_runs),
             "output_ms": statistics.median(out_runs), "full_update_ms": full_ms}, shapes)


def es_conf():
    """examples/early_stopping.py's MLP."""
    from deeplearning4j_tpu_torch import (DenseLayer, InputType, MultiLayerConfiguration,
                                          OutputLayer, UpdaterConfig)

    return MultiLayerConfiguration(
        layers=[DenseLayer(n_out=24, activation="tanh"),
                OutputLayer(n_out=3, activation="softmax", loss="mcxent")],
        input_type=InputType.feed_forward(6),
        updater=UpdaterConfig(updater="adam", learning_rate=5e-3))


def es_batches(n, seed):
    """examples/early_stopping.py's batches: 32 rows of 6 features, the
    class the argmax of a fixed projection."""
    import numpy as np

    from deeplearning4j_tpu_torch import DataSet

    w = np.random.default_rng(3).normal(size=(6, 3))
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = r.normal(size=(32, 6)).astype(np.float32)
        out.append(DataSet(x, np.eye(3, dtype=np.float32)[(x @ w).argmax(-1)]))
    return out


def early_stopping_run(torch, host, directory, dev):
    """The example's early stopping from ``host``'s weights on ``dev``,
    with a LocalFileModelSaver that also keeps a clone of each net it
    saves. Returns (result, saver, launches, seconds)."""
    from deeplearning4j_tpu_torch import (ListDataSetIterator, MultiLayerNetwork,
                                          load_jax_params, ops)
    from deeplearning4j_tpu_torch.earlystopping import (
        DataSetLossCalculator, EarlyStoppingConfiguration, EarlyStoppingTrainer,
        LocalFileModelSaver, MaxEpochsTerminationCondition,
        ScoreImprovementEpochTerminationCondition)

    class Keeping(LocalFileModelSaver):
        def save_best_model(self, net, score):
            super().save_best_model(net, score)
            self.kept = net.clone()

    net = load_jax_params(MultiLayerNetwork(es_conf(), device=dev), host)
    saver = Keeping(directory, device=dev)
    cfg = EarlyStoppingConfiguration(
        epoch_termination_conditions=[MaxEpochsTerminationCondition(ES_MAX_EPOCHS),
                                      ScoreImprovementEpochTerminationCondition(ES_PATIENCE)],
        score_calculator=DataSetLossCalculator(ListDataSetIterator(es_batches(4, 99))),
        model_saver=saver)
    if dev == "cuda":
        torch.cuda.synchronize()
    ops.reset_counters()
    t0 = time.perf_counter()
    result = EarlyStoppingTrainer(cfg, net, ListDataSetIterator(es_batches(8, 0))).fit()
    if dev == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for k, v in ops.counters().items() if v} if dev == "cuda" else None
    return result, saver, launches, seconds


def phase_early_stopping(torch, card):
    """EarlyStoppingTrainer over examples/early_stopping.py's MLP on the
    card with LocalFileModelSaver, against the same run on the CPU from the
    same weights: the termination reason and details, the best epoch and
    the epoch count equal, each epoch's score within ES_SCORE_REL; the best
    model restored from its zip serves bit for bit what the saved net did;
    exact launches (each update: one softmax-xent forward and backward and
    one Adam launch; each score: one forward a score batch). Returns
    (launches, times, leaf shapes)."""
    import tempfile

    import numpy as np

    host = conf_host(es_conf())
    with tempfile.TemporaryDirectory() as tmp:
        card_res, saver, launches, card_s = early_stopping_run(
            torch, host, os.path.join(tmp, "card"), "cuda")
        cpu_res, _, _, _ = early_stopping_run(torch, host, os.path.join(tmp, "cpu"), "cpu")
        x = np.concatenate([ds.features for ds in es_batches(4, 99)])
        restored = card_res.best_model
        same_output = bool(np.array_equal(restored.output(x), saver.kept.output(x)))
    scores_rel = max(abs(card_res.score_vs_epoch[e] - s) / abs(s)
                     for e, s in cpu_res.score_vs_epoch.items())
    epochs, updates = card_res.total_epochs, card_res.total_epochs * 8
    expected = {"softmax_xent_fwd": updates + 4 * len(card_res.score_vs_epoch),
                "softmax_xent_bwd": updates, "adam_update": updates}
    same = (card_res.termination_reason == cpu_res.termination_reason
            and card_res.termination_details == cpu_res.termination_details
            and card_res.best_model_epoch == cpu_res.best_model_epoch
            and epochs == cpu_res.total_epochs
            and sorted(card_res.score_vs_epoch) == sorted(cpu_res.score_vs_epoch))
    ok = same and scores_rel <= ES_SCORE_REL and same_output and launches == expected
    emit("early_stopping", termination_reason=card_res.termination_reason.value,
         details=card_res.termination_details, best_epoch=card_res.best_model_epoch,
         total_epochs=epochs, cpu_termination_reason=cpu_res.termination_reason.value,
         cpu_best_epoch=cpu_res.best_model_epoch, cpu_total_epochs=cpu_res.total_epochs,
         card_scores=[card_res.score_vs_epoch[e] for e in sorted(card_res.score_vs_epoch)],
         cpu_scores=[cpu_res.score_vs_epoch[e] for e in sorted(cpu_res.score_vs_epoch)],
         scores_max_rel=scores_rel, limit=ES_SCORE_REL, restored_output_bitwise=same_output,
         kernel_launches=launches, expected_launches=expected, seconds=card_s,
         ms_per_epoch=card_s * 1e3 / epochs, ok=ok, gpu=card)
    if not ok:
        raise AssertionError("early stopping on the card differs from the CPU")
    return launches, {"ms_per_epoch": card_s * 1e3 / epochs}, [
        np.shape(p[k]) for p in host for k in sorted(p)]


def phases_slice19(torch, card, res_host, res_state, full_ms):
    """Slice 19's phases, each counting from 0. Returns (launches by path,
    times by path, leaf shapes by path)."""
    launches, times, shapes = {}, {}, {}
    dbn_launches, times["dbn"], dbn_shapes = phase_train_dbn(torch, card)
    launches.update(dbn_launches)
    shapes.update(dbn_shapes)
    launches["dbn_digits"], acc, ms, shapes["dbn_digits"] = phase_train_dbn_digits(torch, card)
    times["dbn_digits"] = {"accuracy": acc, "finetune_ms_per_update": ms}
    launches["vae"], times["vae"], shapes["vae"] = phase_pretrain_vae(torch, card)
    (launches["resnet50_transfer"], times["resnet50_transfer"],
     shapes["resnet50_transfer"]) = phase_transfer_resnet50(torch, res_host, res_state,
                                                            full_ms, card)
    (launches["early_stopping"], times["early_stopping"],
     shapes["early_stopping"]) = phase_early_stopping(torch, card)
    return launches, times, shapes


def kernels_slice19(torch, sx, ad, card, leaf_shapes):
    """Rows 10-12 at the shapes of slice 19's paths that no earlier phase
    holds, against their plain versions, then timed beside them, their
    bounds and the library call: rows 10-11 at early stopping's head (N=32,
    C=3); row 12 at each path's leaves (one grouped call). Returns
    {(path, kernel): (max abs err, times, shape)}."""
    out = {}
    N, C = 32, 3
    e = sxent_case(torch, sx, N, C, "float32", "one_hot", SEED + 70)
    for (k, _), t in time_sxent(torch, sx, N, C, ("float32",), card,
                                "early stopping's loss head").items():
        out[("early_stopping", k)] = (e["loss"] if k.endswith("fwd") else max(e["dx"], e["dl"]),
                                      t, f"N={N} C={C}")
    _, sc = adam_inputs(torch, SEED)
    for i, (path, shapes) in enumerate(sorted(leaf_shapes.items())):
        leaves, _ = adam_inputs(torch, SEED + 71 + i, shapes)
        want = -(-len(shapes) // ad.MAX_LEAVES)
        err = adam_check(torch, ad, path, leaves, sc, want_launches=want)
        out[(path, "adam_update")] = (err, time_adam(
            torch, ad, card, shapes, f"{path}'s {len(shapes)} leaves"), f"{len(shapes)} leaves")
    return out


# ---- slice 20: training observability (the Telemetry session, the listener
# catalog, memory reports, the watchdog and the flight recorder) and the
# rest of the optimizers (the seven optax updaters, the batch solvers).
# ResNet-50 at bench.py:180's B=128 trains with LAMB (lr TEL_LR) under
# Telemetry(fetch_every=TEL_FETCH) and the Score, Performance and
# CollectScores listeners: TEL_UPDATES per-batch updates, then
# fit(stage_on_device=STAGED_K) over TEL_STAGED_BATCHES host batches
TEL_LR, TEL_FETCH, TEL_UPDATES, TEL_STAGED_BATCHES = 1e-2, 4, 4, 8
TEL_TIMED = 2  # timed updates (eager) or windows (replayed) a turn, 4 turns
TEL_LOSS_SCALE = 1024.0
# the telemetry row's grad norm against a float64 recompute from the
# _last_grads a needs_gradients listener sees (both sum f32 values; the
# norm of 25.6M squares in another order reads ~1e-7)
TEL_NORM_REL = 1e-5
# LAMB's first update at B=RES_CPU_B, card against CPU (lamb_readings: the
# first loss; the norm of each tensor's change; the whole change's
# direction). LAMB's first step is lr * ||p|| * u/||u|| per tensor, u =
# g/(|g| + eps) elementwise, so the norm of each tensor's change is set by
# the params and holds tight; its direction is sign-like, and a gradient
# element within the f32 gradients' 2-3% of 0 can flip (each flip moves
# 2 lr ||p||/sqrt(n)). Read on the H100: loss 1.4e-7, the worst
# tensor's norm 1.8e-3, the whole change's direction 0.129 (one tensor's
# alone up to 0.35: a BN beta, whose zero params take u itself, 64
# elements, a few flipped). LAMB without its trust ratio moves each tensor
# by lr * u instead: a convolution's change by sqrt(fan_in/2) (17 at
# fan_in 576), the output layer's by 100 (read: norm 98.9, direction 14.8).
LAMB_LIMITS = {"first_loss_rel": 1e-5, "first_norm_rel": 2e-2, "first_change_rel": 0.5}
# the seven updaters on the char-RNN at bench.py:288-301's widths: one
# batch of TBPTT(50) segments (UPD_T steps: 3 updates), card against CPU by
# recipe_readings; a staged window of STAGED_K standard-backprop updates
# (T=STEPS) against per-batch fit on the card, bit for bit
UPDATERS_SEVEN = ("adamw", "adamax", "adadelta", "adagrad", "rmsprop", "lamb", "lion")
UPD_T, UPD_LR = 3 * TBPTT, 1e-3
# each updater's change against the CPU's. The plain-op updaters round as
# the CPU's do but for the order of the products' sums (and CUDA's rsqrt,
# 2 ulp): read on the H100, loss 0-2.2e-7, change 1.7e-6 to 2.1e-5
# (adagrad). lion takes the sign of each element, so a gradient element
# that rounds to the other side of 0 moves 2 lr: its change read 9.9e-3
# (261 of 3.4M elements more than lr/10 apart). adadelta at the conf's lr
# (1e-3 against optax's 1.0) reads a change of 0.9997.
UPD_LIMITS = {"loss_rel": 1e-4, "change_rel": 1e-3}
UPD_LIMITS_BY = {"lion": {"loss_rel": 1e-4, "change_rel": 5e-2}}
# the Iris pin's MLP (train_iris) from JAX's weights, on the full set of
# 150: each solver's score and score history after SOLVER_ITERATIONS, card
# against CPU. Both run f32 forwards and backwards and float64 host logic;
# LBFGS's curvature pairs amplify a rounding apart (JAX and the port on the
# CPU: 2e-6 at 10 iterations, 4% at 25; tests/test_torch_solvers.py). Read
# on the H100: LBFGS's final score 3.7e-5, its history 2.0e-4; the
# others 0 and 6.2e-7.
SOLVERS = ("lbfgs", "conjugate_gradient", "line_gradient_descent")
SOLVER_ITERATIONS, SOLVER_SCORE_REL = 10, 1e-3
# the MNIST MLP (B=512) with one batch's features NaN: per batch (6
# batches, the 3rd poisoned) and staged (8 batches in windows of 4, the
# 6th poisoned); every finite step's grad norm is above WATCH_NORM_LIMIT
WATCH_BATCHES, WATCH_STAGED_BATCHES, WATCH_NORM_LIMIT = (6, 2), (8, 5), 1e-6
# rows 10-12 and 6-7 of slice 20's paths: the row of an earlier path whose
# shape each has (its error and times, of this run, go in the path's row),
# or None: held and timed at the path's own shape (kernels_slice20)
SLICE20_ROWS = {
    "telemetry_resnet50": {"softmax_xent_fwd": "softmax_xent_fwd@resnet50",
                           "softmax_xent_bwd": "softmax_xent_bwd@resnet50"},
    "updaters_char_rnn": {k: f"{k}@graph_char_rnn" for k in (
        "lstm_seq_train_fwd", "lstm_seq_bwd", "drw_product", "softmax_xent_fwd",
        "softmax_xent_bwd")},
    "solver_iris": {"softmax_xent_fwd": None, "softmax_xent_bwd": None},
    "watchdog_flight": {"softmax_xent_fwd": "softmax_xent_fwd@mlp",
                        "softmax_xent_bwd": "softmax_xent_bwd@mlp",
                        "adam_update": "adam_update@mlp"},
}


class FetchCounter:
    """Counts ``Telemetry._fetch`` (the session's host reads) while
    installed, and keeps the rows each read brought back."""

    def __init__(self):
        from deeplearning4j_tpu_torch.telemetry import Telemetry

        self.cls, self.real = Telemetry, Telemetry.__dict__["_fetch"]
        self.calls, self.rows = 0, []

    def __enter__(self):
        real = self.real.__func__

        def fetch(t):
            self.calls += 1
            out = real(t)
            self.rows.extend(out.tolist())
            return out

        self.cls._fetch = staticmethod(fetch)
        return self

    def __exit__(self, *exc):
        self.cls._fetch = self.real


def tel_session(registry=None, **kw):
    from deeplearning4j_tpu_torch.telemetry import FlightRecorder, MetricsRegistry, Telemetry

    reg = registry if registry is not None else MetricsRegistry()
    return Telemetry(registry=reg, flight_recorder=FlightRecorder(registry=reg), **kw)


def tel_listeners(registry):
    """The Score, Performance and CollectScores listeners on ``registry``;
    CollectScores last (its scores are the losses fit reported)."""
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresIterationListener, PerformanceListener, ScoreIterationListener)

    return [ScoreIterationListener(print_every=1, registry=registry),
            PerformanceListener(frequency=1, registry=registry),
            CollectScoresIterationListener()]


class NormRecompute:
    """A needs_gradients listener: the float64 norm of the ``_last_grads``
    it sees, recomputed on the host."""

    needs_gradients = True
    frequency = 1

    def __init__(self):
        self.norms = []

    def iteration_done(self, net, iteration, score):
        import numpy as np

        self.norms.append(float(np.sqrt(sum(
            np.sum(g.detach().double().cpu().numpy() ** 2)
            for layer in net._last_grads for g in layer.values()))))


def scaled_norm_fault():
    """The wrong telemetry: the grad norm of the scaled gradients (times
    the conf's loss scale, TEL_LOSS_SCALE). Returns the undo."""
    from deeplearning4j_tpu_torch.telemetry import device

    real = device.step_stats

    def wrong(loss, grads=None):
        if grads is not None:
            grads = [{k: g * TEL_LOSS_SCALE for k, g in layer.items()} for layer in grads]
        return real(loss, grads)

    device.step_stats = wrong

    def undo():
        device.step_stats = real
    return undo


def lamb_fault():
    """LAMB without its trust ratio. Returns the undo."""
    from deeplearning4j_tpu_torch.nn import updaters

    real = updaters._trust_ratio
    updaters._trust_ratio = lambda u, p: u

    def undo():
        updaters._trust_ratio = real
    return undo


def lamb_conf(loss_scale=None):
    from deeplearning4j_tpu_torch import UpdaterConfig, resnet50_conf

    conf = resnet50_conf(updater=UpdaterConfig(updater="lamb", learning_rate=TEL_LR))
    conf.loss_scale = loss_scale
    return conf


def lamb_first_update(torch, host, batch, device, fault=False):
    """One LAMB update of ResNet-50 from the seed params on ``device``:
    (loss, params after)."""
    import numpy as np

    from deeplearning4j_tpu_torch import params_to_numpy

    undo = lamb_fault() if fault else (lambda: None)
    try:
        net = resnet_net(lamb_conf(), host, device=device)
        rec = LossRecorder()
        net.set_listeners(rec)
        net.fit(batch)
        out = float(rec.losses[0]), params_to_numpy(net)
    finally:
        undo()
    del net
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def lamb_readings(run, ref, host) -> dict:
    """LAMB's first update on the card against the CPU's: the loss relative
    to the CPU's; the relative difference of each tensor's change's norm
    from the CPU's (the largest, and its tensor); the whole model's change
    against the CPU's relative to the norm of the CPU's (direction), and
    the largest such reading of one tensor (reported)."""
    import numpy as np

    seed = named_tensors(host)
    mine, theirs = named_tensors(run[1]), named_tensors(ref[1])
    change, norm, diff2, ref2 = {}, {}, 0.0, 0.0
    for k, q in theirs.items():
        d_ref = q - seed[k].astype(np.float32)
        d = mine[k] - seed[k].astype(np.float32)
        n_ref = float(np.linalg.norm(d_ref))
        n_diff = float(np.linalg.norm(d - d_ref))
        diff2, ref2 = diff2 + n_diff ** 2, ref2 + n_ref ** 2
        change[k] = n_diff / n_ref if n_ref else 0.0
        norm[k] = abs(float(np.linalg.norm(d)) / n_ref - 1.0) if n_ref else 0.0
    return {"first_loss_rel": abs(run[0] - ref[0]) / abs(ref[0]),
            "first_norm_rel": max(norm.values()),
            "first_change_rel": float(np.sqrt(diff2 / ref2)),
            "first_norm_worst_tensor": max(norm, key=norm.get),
            "worst_tensor_change_rel": max(change.values()),
            "worst_tensor": max(change, key=change.get)}


def phase_telemetry_resnet50(torch, host, card):
    """ResNet-50 (B=128, f32) on LAMB under telemetry. LAMB's first update at
    B=RES_CPU_B against the CPU (LAMB_LIMITS), LAMB without its trust ratio
    caught. Then from the same weights: TEL_UPDATES per-batch updates and
    fit(stage_on_device=4) over TEL_STAGED_BATCHES host batches under
    Telemetry(fetch_every=TEL_FETCH) with the Score, Performance and
    CollectScores listeners: every fetched row's loss equals the loss fit
    reported, bit for bit; no row non-finite; one host read per TEL_FETCH
    per-batch updates and one per staged window (counted through
    ``_fetch``); dl4jtpu_train_steps_total the updates taken. The grad norm
    of a row against a float64 recompute from ``_last_grads`` (a
    ParamAndGradientIterationListener and a needs_gradients listener
    attached), with loss_scale None and TEL_LOSS_SCALE; the norm of the
    scaled gradients caught. memory_report's param, grad and optimizer
    totals equal the live tensors' bytes, and the call allocates nothing on
    the card; its projected peak beside the peak allocated. Then ms per
    update with telemetry off and on, eager (batch on the card) and
    replayed, in turns (off, on, on, off). Returns (launch counts,
    times)."""
    import numpy as np

    from deeplearning4j_tpu_torch import DataSet, ListDataSetIterator, ops
    from deeplearning4j_tpu_torch.optimize.listeners import ParamAndGradientIterationListener
    from deeplearning4j_tpu_torch.telemetry import MetricsRegistry

    t0 = time.perf_counter()
    small = alexnet_images(RES_CPU_B, SEED + 12)
    card_run = lamb_first_update(torch, host, small, "cuda")
    cpu_run = lamb_first_update(torch, host, small, "cpu")
    readings = lamb_readings(card_run, cpu_run, host)
    fault = lamb_readings(lamb_first_update(torch, host, small, "cuda", fault=True),
                          cpu_run, host)
    fault["caught"] = not within_limits(fault, LAMB_LIMITS)
    compared_s = time.perf_counter() - t0

    batches = [DataSet(*alexnet_images(RES_B, SEED + 80 + i)) for i in range(3)]
    reg = MetricsRegistry()
    tel = tel_session(reg, fetch_every=TEL_FETCH)
    listeners = tel_listeners(reg)
    net = resnet_net(lamb_conf(), host)
    net.set_telemetry(tel)
    net.set_listeners(*listeners)
    torch.cuda.synchronize()
    ops.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    with FetchCounter() as per_batch:
        net.fit(ListDataSetIterator([batches[i % 3] for i in range(TEL_UPDATES)]))
    with FetchCounter() as staged:
        net.fit(ListDataSetIterator([batches[i % 3] for i in range(TEL_STAGED_BATCHES)]),
                stage_on_device=STAGED_K)
    torch.cuda.synchronize()
    launches = ops.counters()
    peak = torch.cuda.max_memory_allocated()
    scores = [s for _, s in listeners[2].scores]
    rows = per_batch.rows + staged.rows
    row_losses_equal = [np.float32(r[0]) for r in rows] == [np.float32(s) for s in scores]
    steps_total = reg.get("dl4jtpu_train_steps_total").value
    staged_windows = -(-TEL_STAGED_BATCHES // STAGED_K)
    reads_ok = (per_batch.calls == -(-TEL_UPDATES // TEL_FETCH)
                and staged.calls == staged_windows)

    import gc

    gc.collect()
    before = torch.cuda.memory_allocated()
    report = net.memory_report(RES_B)
    allocated_by_report = torch.cuda.memory_allocated() - before
    param_bytes = sum(p.numel() * p.element_size() for p in net.parameters())
    opt_bytes = sum(t.numel() * t.element_size() for t in net.updater_state_leaves())
    totals = report["totals"]
    report_ok = (allocated_by_report == 0 and totals["param_bytes"] == param_bytes
                 and totals["grad_bytes"] == param_bytes
                 and totals["opt_state_bytes"] == opt_bytes)
    net.set_listeners()
    net.set_telemetry(None)
    perf = listeners[1].history

    # the grad norm against a recompute, loss scale off and on, and wrong
    norm_runs = {}
    for how in ("plain", "loss_scale", "scaled_norm_fault"):
        undo = scaled_norm_fault() if how == "scaled_norm_fault" else (lambda: None)
        try:
            n = resnet_net(lamb_conf(None if how == "plain" else TEL_LOSS_SCALE), host)
            grads = NormRecompute()
            n.set_listeners(*([ParamAndGradientIterationListener(iterations=1)]
                              if how == "plain" else []), grads)
            n.set_telemetry(tel_session(fetch_every=1, sample_memory=False))
            with FetchCounter() as reads:
                n.fit(batches[0])
        finally:
            undo()
        row = reads.rows[0]
        norm_runs[how] = {"row_grad_norm": row[1], "recomputed": grads.norms[0],
                          "rel": abs(row[1] - grads.norms[0]) / grads.norms[0],
                          "nonfinite": row[2], "param_and_gradient_fields": (
                              len(n.listeners[0].lines[-1].split("\t"))
                              if how == "plain" else None)}
        del n
        torch.cuda.empty_cache()
    norm_ok = (norm_runs["plain"]["rel"] <= TEL_NORM_REL
               and norm_runs["loss_scale"]["rel"] <= TEL_NORM_REL
               and norm_runs["scaled_norm_fault"]["rel"] > TEL_NORM_REL)

    # ms per update, telemetry off and on, eager then replayed, in turns
    on_card = tuple(torch.as_tensor(a, device=DEVICE) for a in (batches[0].features,
                                                                 batches[0].labels))
    slots = staged_slots(torch, SEED + 90)
    timed = {"eager": {"off": [], "on": []}, "replayed": {"off": [], "on": []}}
    for how in ("off", "on"):  # capture both steps first
        net.set_telemetry(tel_session(fetch_every=TEL_FETCH) if how == "on" else None)
        net.fit_on_device(*slots)
    for how in ("off", "on", "on", "off"):
        net.set_telemetry(tel_session(fetch_every=TEL_FETCH) if how == "on" else None)
        times, _, _ = timed_fit(torch, net, on_card, 1, TEL_TIMED)
        timed["eager"][how].extend(times)
        for _ in range(TEL_TIMED):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            net.fit_on_device(*slots)
            torch.cuda.synchronize()
            timed["replayed"][how].append((time.perf_counter() - t1) * 1e3 / STAGED_K)
    net.set_telemetry(None)
    ms = {path: {how: statistics.median(v) for how, v in d.items()}
          for path, d in timed.items()}
    del net
    gc_collect(torch)
    # SGD (the conf's own updater, lr 0.1) replayed on the same slots, for
    # LAMB's cost against it
    sgd_conf = lamb_conf()
    sgd_conf.updater = {**sgd_conf.updater, "updater": "sgd", "learning_rate": 0.1}
    sgd = resnet_net(sgd_conf, host)
    sgd.fit_on_device(*slots)
    sgd_ms = []
    for _ in range(2 * TEL_TIMED):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sgd.fit_on_device(*slots)
        torch.cuda.synchronize()
        sgd_ms.append((time.perf_counter() - t1) * 1e3 / STAGED_K)
    del sgd, on_card, slots
    gc_collect(torch)
    ok = (within_limits(readings, LAMB_LIMITS) and fault["caught"] and row_losses_equal
          and len(rows) == TEL_UPDATES + TEL_STAGED_BATCHES
          and all(r[2] == 0.0 for r in rows) and reads_ok
          and steps_total == TEL_UPDATES + TEL_STAGED_BATCHES and report_ok and norm_ok
          and launches.get("softmax_xent_fwd", 0) > 0 and launches.get("softmax_xent_bwd", 0) > 0)
    emit("telemetry_resnet50", B=RES_B, updater="lamb", lr=TEL_LR,
         first_update_batch=RES_CPU_B, first_update_vs_cpu=readings, limits=LAMB_LIMITS,
         fault_lamb_without_trust_ratio=fault, compared_s=compared_s,
         fetch_every=TEL_FETCH, per_batch_updates=TEL_UPDATES, per_batch_reads=per_batch.calls,
         staged_batches=TEL_STAGED_BATCHES, staged_windows=staged_windows,
         staged_reads=staged.calls, row_losses_equal_fit_losses=row_losses_equal,
         rows=rows, train_steps_total=steps_total,
         performance_listener=perf[-2:], grad_norm=norm_runs, norm_limit=TEL_NORM_REL,
         memory_report_totals=totals, memory_report_top=report["top_consumers"],
         memory_report_allocated_bytes=allocated_by_report,
         live_param_bytes=param_bytes, live_opt_state_bytes=opt_bytes,
         projected_peak_gib=totals["projected_peak_bytes"] / 2 ** 30,
         max_memory_allocated_gib=peak / 2 ** 30, ms_per_update_runs=timed,
         ms_per_update=ms, telemetry_share={
             path: d["on"] / d["off"] - 1.0 for path, d in ms.items()},
         sgd_replayed_ms_runs=sgd_ms, sgd_replayed_ms_per_update=statistics.median(sgd_ms),
         lamb_minus_sgd_replayed_ms=ms["replayed"]["off"] - statistics.median(sgd_ms),
         kernel_launches=launches, phase_seconds=time.perf_counter() - t0, ok=ok, gpu=card)
    if not ok:
        raise AssertionError("telemetry on ResNet-50 failed its checks")
    return launches, {"lamb_ms_per_update": ms,
                      "sgd_replayed_ms_per_update": statistics.median(sgd_ms),
                      "memory_report_projected_gib":
                      totals["projected_peak_bytes"] / 2 ** 30,
                      "max_memory_allocated_gib": peak / 2 ** 30}


def updater_char_rnn_conf(name, backprop="tbptt"):
    from deeplearning4j_tpu_torch import UpdaterConfig, char_rnn

    conf = char_rnn(VOCAB, HIDDEN, LAYERS, tbptt_length=TBPTT)
    conf.updater = UpdaterConfig(updater=name, learning_rate=UPD_LR).to_dict()
    conf.backprop_type = backprop
    return conf


def phase_updaters_char_rnn(torch, host_params, card):
    """The seven optax updaters on the char-RNN at full width (vocab 96,
    H=512, 2 layers, B=64), from the same weights: each trains one batch
    of UPD_T steps under TBPTT(50) (3 updates) on the card and the CPU, held
    by recipe_readings at UPD_LIMITS; adadelta at the conf's learning rate
    caught. Then each trains a staged window of STAGED_K standard-backprop
    updates (T=256) on the card against per-batch fit over the same batches
    from the same weights: the losses and params bit for bit. Returns
    (launch counts, ms per staged update by updater)."""
    import numpy as np

    from deeplearning4j_tpu_torch import MultiLayerNetwork, load_jax_params, ops, params_to_numpy
    from deeplearning4j_tpu_torch.nn.updaters import build_schedule

    batches = char_batches(STAGED_K, SEED + 95)
    x, y = (a[:, :UPD_T] for a in batches[0])
    xs = torch.as_tensor(np.stack([b[0] for b in batches]), device=DEVICE)
    ys = torch.as_tensor(np.stack([b[1] for b in batches]), device=DEVICE)

    def train(name, dev, fault=False):
        net = load_jax_params(MultiLayerNetwork(updater_char_rnn_conf(name), device=dev),
                              host_params)
        if fault:
            net._updater_ready().schedule = build_schedule(UPD_LR)
        rec = LossRecorder()
        net.set_listeners(rec)
        net.fit((x, y))
        return net, np.array([float(l) for l in rec.losses]), params_to_numpy(net)

    torch.cuda.synchronize()
    ops.reset_counters()
    results, staged_ms = {}, {}
    for name in UPDATERS_SEVEN:
        card_run, cpu_run = train(name, "cuda"), train(name, "cpu")
        r = recipe_readings(card_run, cpu_run, host_params, lr=UPD_LR)
        r["within"] = within_limits(r, UPD_LIMITS_BY.get(name, UPD_LIMITS))
        r["updates"] = len(card_run[1])
        if name == "adadelta":
            f = recipe_readings(train(name, "cuda", fault=True), cpu_run, host_params,
                                lr=UPD_LR)
            f["caught"] = not within_limits(f, UPD_LIMITS)
            r["fault_adadelta_at_conf_lr"] = f
        del card_run
        # the staged window against per-batch fit, on the card
        staged = load_jax_params(MultiLayerNetwork(updater_char_rnn_conf(name, "standard")),
                                 host_params)
        plain = load_jax_params(MultiLayerNetwork(updater_char_rnn_conf(name, "standard")),
                                host_params)
        staged.warmup(xs, ys)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses = staged.fit_on_device(xs, ys)
        torch.cuda.synchronize()
        staged_ms[name] = (time.perf_counter() - t1) * 1e3 / STAGED_K
        want = []
        for i in range(STAGED_K):
            plain.fit((xs[i], ys[i]))
            want.append(plain.score())
        r["staged_bit_for_bit"] = (np.array_equal(losses, np.float32(want)) and all(
            torch.equal(p, q) for p, q in zip(staged.parameters(), plain.parameters())) and all(
            torch.equal(a, b) for a, b in zip(staged.updater_state_leaves(),
                                              plain.updater_state_leaves())))
        r["staged_replays"] = staged._step_graphs.replays
        r["replays_expected"] = STAGED_K if staged.device.type == "cuda" else 0
        results[name] = r
        del staged, plain
        gc_collect(torch)
    torch.cuda.synchronize()
    launches = ops.counters()
    ok = (all(r["within"] and r["staged_bit_for_bit"] and r["updates"] == UPD_T // TBPTT
              and r["staged_replays"] == r["replays_expected"] for r in results.values())
          and results["adadelta"]["fault_adadelta_at_conf_lr"]["caught"]
          and all(launches.get(k, 0) > 0 for k in SLICE20_ROWS["updaters_char_rnn"]))
    emit("updaters_char_rnn", B=BATCH, H=HIDDEN, layers=LAYERS, vocab=VOCAB,
         compared_steps=UPD_T, tbptt=TBPTT, staged_T=STEPS, staged_window=STAGED_K,
         lr=UPD_LR, readings_vs_cpu=results, limits=UPD_LIMITS, limits_by_updater=UPD_LIMITS_BY,
         staged_ms_per_update=staged_ms, kernel_launches=launches, ok=ok, gpu=card)
    if not ok:
        raise AssertionError("the seven updaters on the char-RNN failed their checks")
    return launches, staged_ms


def phase_solver_iris(torch, card):
    """Solver("lbfgs"), "conjugate_gradient" and "line_gradient_descent" on
    the Iris pin's MLP from JAX's weights (REAL_DATA_INIT), full set of 150
    (the bundled iris.csv), SOLVER_ITERATIONS each from the same weights on
    the card and the CPU: the score after each at SOLVER_SCORE_REL of the
    CPU's, its score history too; the full-set accuracy of each. Returns
    (launch counts, the card's seconds by solver)."""
    import numpy as np

    from deeplearning4j_tpu_torch import DataSet, MultiLayerNetwork, load_jax_params, ops
    from deeplearning4j_tpu_torch.datasets.fetchers import load_iris
    from deeplearning4j_tpu_torch.optimize.solvers import Solver

    xf, yi = load_iris()
    data = DataSet(xf, one_hot(yi, 3))
    conf, host = real_data_models()["iris"][1], real_data_host("iris")
    torch.cuda.synchronize()
    ops.reset_counters()
    out, seconds = {}, {}
    for algorithm in SOLVERS:
        runs = {}
        for dev in ("cuda", "cpu"):
            net = load_jax_params(MultiLayerNetwork(conf, device=dev), host)
            solver = Solver(algorithm, max_iterations=SOLVER_ITERATIONS)
            t1 = time.perf_counter()
            score = solver.optimize(net, data)
            if dev == "cuda":
                torch.cuda.synchronize()
                seconds[algorithm] = time.perf_counter() - t1
            runs[dev] = (score, solver.score_history, net.evaluate(data).accuracy())
        (cs, ch, ca), (ps, ph, pa) = runs["cuda"], runs["cpu"]
        hist_rel = (max(abs(a - b) / abs(b) for a, b in zip(ch, ph))
                    if len(ch) == len(ph) else float("inf"))
        out[algorithm] = {"score": cs, "cpu_score": ps, "score_rel": abs(cs - ps) / abs(ps),
                          "history_rel": hist_rel, "iterations": len(ch),
                          "start_score": ch[0], "accuracy": ca, "cpu_accuracy": pa}
    torch.cuda.synchronize()
    launches = ops.counters()
    ok = (all(r["score_rel"] <= SOLVER_SCORE_REL and r["history_rel"] <= SOLVER_SCORE_REL
              and r["score"] < r["start_score"] for r in out.values())
          and launches.get("softmax_xent_fwd", 0) > 0
          and launches.get("softmax_xent_bwd", 0) > 0)
    emit("solver_iris", examples=len(xf), iterations=SOLVER_ITERATIONS, solvers=out,
         limit=SOLVER_SCORE_REL, card_seconds=seconds, kernel_launches=launches, ok=ok,
         gpu=card)
    if not ok:
        raise AssertionError("the solvers on Iris failed their checks")
    return launches, seconds


def phase_watchdog_flight(torch, card):
    """The MNIST MLP (B=512, Adam) with one batch's features NaN, per batch
    (WATCH_BATCHES: 6 batches, the 3rd poisoned; fetch_every 2) and staged
    (8 batches in windows of 4, the 6th poisoned), each under a Watchdog
    (grad_norm_limit WATCH_NORM_LIMIT, below every finite step's norm) and
    a FlightRecorder: the first nan-loss anomaly at the poisoned iteration,
    read from the fetched row; exploding-grad-norm at the first iteration;
    a dump bundle for each kind, whose events hold the step rows (the
    poisoned one non-finite) and, staged, the windows. Returns (launch
    counts, the bundles' sizes)."""
    import math
    import shutil
    import tempfile

    from deeplearning4j_tpu_torch import (DataSet, ListDataSetIterator, MnistDataSetIterator,
                                          MultiLayerNetwork, load_jax_params, ops)
    from deeplearning4j_tpu_torch.telemetry import (FlightRecorder, MetricsRegistry,
                                                    Telemetry, Watchdog)

    B, conf = mnist_models()["mlp"]
    host = conf_host(conf)
    base = [DataSet(ds.features.reshape(-1, 784), ds.labels)
            for ds in MnistDataSetIterator(batch=B, num_examples=B * 8)]
    tmp = tempfile.mkdtemp(prefix="dl4j_flight_")
    torch.cuda.synchronize()
    ops.reset_counters()
    out = {}
    try:
        for mode, (n, poisoned) in (("per_batch", WATCH_BATCHES),
                                    ("staged", WATCH_STAGED_BATCHES)):
            data = [DataSet(base[i].features.copy(), base[i].labels) for i in range(n)]
            data[poisoned].features[:] = float("nan")
            reg = MetricsRegistry()
            fr = FlightRecorder(registry=reg, dump_dir=os.path.join(tmp, mode))
            wd = Watchdog(sinks=[], registry=reg, grad_norm_limit=WATCH_NORM_LIMIT)
            net = load_jax_params(MultiLayerNetwork(conf), host)
            net.set_telemetry(Telemetry(registry=reg, fetch_every=2, watchdog=wd,
                                        flight_recorder=fr))
            net.fit(ListDataSetIterator(data), stage_on_device=STAGED_K if mode == "staged"
                    else None)
            torch.cuda.synchronize()
            first = {}
            for e in wd.events:
                first.setdefault(e.kind, e.iteration)
            bundles = {}
            for path in fr.dumps:
                with open(path) as fh:
                    b = json.load(fh)
                bundles[b["reason"]] = b
            nan_bundle = bundles.get("nan-loss", {"events": []})
            steps = [e for e in nan_bundle["events"] if e["kind"] == "step"]
            poisoned_row = next((e for e in steps if e["iteration"] == poisoned + 1), None)
            out[mode] = {
                "batches": n, "poisoned_iteration": poisoned + 1,
                "first_nan_loss": first.get("nan-loss"),
                "first_exploding_grad_norm": first.get("exploding-grad-norm"),
                "dump_reasons": sorted(bundles), "bundle_step_rows": len(steps),
                "poisoned_row": poisoned_row,
                "staged_windows_in_bundle": sum(e["kind"] == "staged_dispatch"
                                                for e in nan_bundle["events"]),
                "bundle_bytes": sum(os.path.getsize(p) for p in fr.dumps),
                "anomalies_total": reg.snapshot()["dl4jtpu_anomalies_total"]["values"]}
            del net
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    launches = ops.counters()
    ok = all(
        r["first_nan_loss"] == r["poisoned_iteration"] and r["first_exploding_grad_norm"] == 1
        and r["dump_reasons"] == ["exploding-grad-norm", "nan-loss"]
        and r["poisoned_row"] is not None and r["poisoned_row"]["nonfinite"] == 1.0
        and r["bundle_step_rows"] >= r["poisoned_iteration"]
        and (mode == "per_batch" or r["staged_windows_in_bundle"] >= 2)
        for mode, r in out.items())
    ok = ok and all(launches.get(k, 0) > 0 for k in SLICE20_ROWS["watchdog_flight"])
    emit("watchdog_flight", B=B, grad_norm_limit=WATCH_NORM_LIMIT, runs=out,
         kernel_launches=launches, ok=ok, gpu=card)
    if not ok:
        raise AssertionError("the watchdog and flight recorder failed their checks")
    return launches, {m: r["bundle_bytes"] for m, r in out.items()}


def phases_slice20(torch, card, res_host, host_params):
    """Slice 20's phases, each counting from 0. Returns (launches by path,
    times by path)."""
    launches, times = {}, {}
    t0 = time.perf_counter()
    launches["telemetry_resnet50"], times["telemetry_resnet50"] = phase_telemetry_resnet50(
        torch, res_host, card)
    launches["updaters_char_rnn"], times["updaters_char_rnn"] = phase_updaters_char_rnn(
        torch, host_params, card)
    launches["solver_iris"], times["solver_iris"] = phase_solver_iris(torch, card)
    launches["watchdog_flight"], times["watchdog_flight"] = phase_watchdog_flight(torch, card)
    times["seconds"] = time.perf_counter() - t0
    return launches, times


def kernels_slice20(torch, sx, card):
    """Rows 10-11 at the solvers' head (N=150, C=3), the one shape of slice
    20's paths that no earlier phase holds, against their plain versions,
    then timed beside them, their bounds and the library call. Returns
    {(path, kernel): (max abs err, times, shape)}."""
    out = {}
    N, C = 150, 3
    e = sxent_case(torch, sx, N, C, "float32", "one_hot", SEED + 150)
    for (k, _), t in time_sxent(torch, sx, N, C, ("float32",), card,
                                "the solvers' Iris head").items():
        out[("solver_iris", k)] = (e["loss"] if k.endswith("fwd") else max(e["dx"], e["dl"]),
                                   t, f"N={N} C={C}")
    return out


# ---- slice 21: the serving front. output(), predict() and rnn_time_step()
# go through runtime.inference by default: rows and time in power-of-two
# buckets, each bucket a CUDA graph captured once into the process-wide
# compile manager and replayed. The phases above hold the eager path (main
# runs them under DL4JTPU_INFER=legacy, the knob that keeps it); slice 21's
# three phases hold the replayed path against that eager path, at full
# width: serve_graphs (GoogLeNet, ResNet-50, the char-RNN), serve_models
# (every other model the phases above serve) and serve_service.
SERVE_ROWS = (1, 3, 17, 64, 100, 128)  # GoogLeNet's request rows: buckets 1, 4, 32, 64, 128
SERVE_CALLS = 5  # timed calls of each, eager and replayed (the median)
CHAR_T_PADDED = 200  # a char-RNN request bucketed to STEPS=256, the mask extended
STREAM_STEPS = 32  # single-step rnn_time_step calls at B=SLOTS
# a padded request against the eager path at the same real rows or steps:
# the serving limits against the CPU (cuDNN and cuBLAS may take other
# algorithms at another row count)
PADDED_REL = {"float32": 1e-5, "bfloat16": 3e-2}
SERVICE_THREADS, SERVICE_MAX_BATCH = 8, 32
SERVICE_WINDOWS, SERVICE_WINDOW_S = 3, 3.0  # timed traffic windows, seconds each
SERVICE_T = 64  # the char-RNN's requests to the service: [rows, 64, 96]
SERVICE_ROWS = (1, 2, 3, 5, 8)
SERVICE_STARTS = (0, 8, 16)  # a request: SERVICE_ROWS rows from one of these offsets
DECODE_ROUNDS = 5  # decode rounds of each server, replayed and eager in turn
# slice 21's kernel rows: (path, kernel, shape name) -> the main line that
# holds the same shape (None: held and timed in kernels_slice21)
SLICE21_ROWS = {
    ("serve_graphs", "lrn_fwd", "googlenet_lrn1"): None,
    ("serve_graphs", "lrn_fwd", "googlenet_lrn2"): None,
    ("serve_graphs", "lstm_seq_lean", "T=256 B=64"): "lstm_seq_lean",
    ("serve_graphs", "lstm_seq_lean_masked", "T=256 B=64"): None,
    ("serve_graphs", "lstm_seq_lean", "T=1 B=8"): None,
    ("serve_models", "flash_attn_fwd", "B=4 T=4096"): "flash_attn_fwd",
    ("serve_models", "lrn_fwd", "lrn1"): None,
    ("serve_models", "lstm_cell_fwd", "B=64"): "lstm_cell_fwd",
    ("serve_models", "lstm_seq_lean", "T=256 B=64"): "lstm_seq_lean",
    ("serve_models", "lstm_seq_lean_masked", "T=1 B=8"): "lstm_seq_lean_masked",
    ("serve_service", "lstm_seq_lean_masked", "T=1 B=8"): "lstm_seq_lean_masked",
}


def legacy(fn):
    """``fn()`` on the eager, shape-exact path (``DL4JTPU_INFER=legacy``):
    the yardstick the replayed path is held against."""
    old = os.environ.get("DL4JTPU_INFER")
    os.environ["DL4JTPU_INFER"] = "legacy"
    try:
        return fn()
    finally:
        if old is None:
            os.environ.pop("DL4JTPU_INFER", None)
        else:
            os.environ["DL4JTPU_INFER"] = old


def call_ms(torch, fn, n: int = SERVE_CALLS) -> list:
    """Host-clock ms of ``n`` calls of ``fn`` (each returns host arrays, so
    each ends with the copy to the host)."""
    runs = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        runs.append((time.perf_counter() - t0) * 1e3)
    return runs


def add_counts(into: dict, counts: dict) -> dict:
    """Add ``counts`` to ``into`` kernel by kernel (zeros left out)."""
    for k, v in counts.items():
        if v:
            into[k] = into.get(k, 0) + v
    return into


def replay_marks() -> dict:
    """Every live served graph and its replays so far, by id."""
    from deeplearning4j_tpu_torch.runtime import inference as inf
    from deeplearning4j_tpu_torch.runtime.compile_manager import get_compile_manager

    return {id(g): (g, g.replays) for _, g in get_compile_manager().owned()
            if isinstance(g, inf.ServedGraph)}


def replayed_since(marks: dict) -> dict:
    """What the served graphs launched by replay since ``marks``: each
    graph's captured launches (one replay's) times its replays since then
    (a graph captured since counts from 0)."""
    graphs = {k: g for k, (g, _) in marks.items()}
    graphs.update({k: g for k, (g, _) in replay_marks().items()})
    out: dict = {}
    for k, g in graphs.items():
        seen = marks.get(k)
        n = g.replays - (seen[1] if seen is not None and seen[0] is g else 0)
        add_counts(out, {name: v * n for name, v in g.launches.items()})
    return out


class Windows:
    """A phase's launch counts: its main path's own runs apart from its
    yardstick's. ``main(fn)`` runs ``fn`` with every count set to 0 just
    before and read just after, and adds what the wrappers counted in it
    (eager launches, a bucket's warm-up run and its capture) to
    ``launches`` and what the served graphs launched by replay in it (each
    graph's captured launches times its replays in the run) to
    ``replayed``; ``yard(fn)`` runs ``fn`` on the eager path (``legacy``),
    its counts into ``yardstick``. What a phase runs outside both (timing,
    wrong versions) is not counted."""

    def __init__(self, torch):
        self.torch = torch
        self.launches, self.replayed, self.yardstick = {}, {}, {}

    def _run(self, fn, counted: dict, replayed):
        from deeplearning4j_tpu_torch import ops

        marks = replay_marks()
        self.torch.cuda.synchronize()
        ops.reset_counters()
        out = fn()
        self.torch.cuda.synchronize()
        add_counts(counted, ops.counters())
        if replayed is not None:
            add_counts(replayed, replayed_since(marks))
        return out

    def main(self, fn):
        return self._run(fn, self.launches, self.replayed)

    def yard(self, fn):
        return self._run(lambda: legacy(fn), self.yardstick, None)


def pool_reading(net) -> dict:
    """``executable_memory`` of ``net``'s served graphs' pool (one pool a
    network)."""
    from deeplearning4j_tpu_torch.runtime import inference as inf
    from deeplearning4j_tpu_torch.telemetry.memory import executable_memory

    graphs = inf.served_graphs(net)
    return executable_memory(graphs[0]) if graphs else {"available": False, "reason": "none"}


def rel_err(got, want) -> float:
    import numpy as np

    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


def retire(torch, net) -> None:
    """Drop a network's served graphs and their pool."""
    from deeplearning4j_tpu_torch.runtime.compile_manager import get_compile_manager

    get_compile_manager().drop_token(net._cm_token)
    gc_collect(torch)


def replayed_vs_eager(torch, net, x, rows, limit, win, **kw) -> dict:
    """One network's served forward, replayed against eager: the full batch
    bit for bit (two replays, and predict against the eager argmax), each
    request of ``rows`` (padded to its bucket where the network pads rows)
    against eager at the same rows within ``limit`` (relative to the largest
    output), no capture on a second pass over every shape, the eager and
    replayed ms of the full batch (median of SERVE_CALLS; beside them the
    full batch's replay alone, its inputs already on the card, CUDA-event
    timed: what is left of a call for the card), the captures, their
    seconds and the graphs' pool. ``kw`` (a mask) goes with the full batch.
    The served calls are ``win``'s main path, the eager ones its
    yardstick; the timed calls are neither."""
    import numpy as np

    from deeplearning4j_tpu_torch.runtime import inference as inf
    from deeplearning4j_tpu_torch.runtime.compile_manager import get_compile_manager

    cm = get_compile_manager()
    c0, s0 = cm.compiles.value, cm.compile_time.summary()["sum"]
    B = x.shape[0]
    eager = win.yard(lambda: net.output(x, **kw))
    wants = {r: win.yard(lambda r=r: net.output(x[:r])) for r in rows if r != B}

    def served():
        got = [net.output(x, **kw), net.output(x, **kw), net.predict(x, **kw)]
        return got, {r: net.output(x[:r]) for r in wants}

    (first, second, pred), gots = win.main(served)
    exact = bool(np.array_equal(first, eager) and np.array_equal(second, eager))
    argmax_exact = bool(np.array_equal(pred, eager.argmax(-1)))
    padded = {r: {"rel_err": rel_err(gots[r], want),
                  "bit_exact": bool(np.array_equal(gots[r], want))}
              for r, want in wants.items()}
    warm = cm.compiles.value

    def again():
        for r in wants:
            net.output(x[:r])
        net.output(x, **kw)
        net.predict(x, **kw)

    win.main(again)
    new_captures = cm.compiles.value - warm
    eager_runs = legacy(lambda: call_ms(torch, lambda: net.output(x, **kw)))
    replay_runs = call_ms(torch, lambda: net.output(x, **kw))
    full = next(g for g in inf.served_graphs(net)
                if tuple(g.inputs[0].shape) == tuple(x.shape) and g.outputs[0].dtype != torch.int32
                and all(m is None for m in g.inputs[1:]) == (not kw))
    return dict(
        replay_alone_ms=median_ms(full.execute),
        bit_exact=exact, predict_exact=argmax_exact, padded=padded, limit=limit,
        padded_ok=all(p["rel_err"] <= limit for p in padded.values()),
        captures=cm.compiles.value - c0,
        capture_seconds=cm.compile_time.summary()["sum"] - s0,
        new_captures_after_warmup=new_captures,
        eager_ms_runs=eager_runs, replayed_ms_runs=replay_runs,
        eager_ms=statistics.median(eager_runs), replayed_ms=statistics.median(replay_runs),
        pool=pool_reading(net))


def unlocked_replays(torch, net, x) -> dict:
    """What the network's lock prevents, replayed by hand. Two requests
    through one graph: the second written into its static input before the
    first replays, so the first reads the second's answer. Two graphs of
    one network: one replayed and its output left on the card while another
    graph of the same pool replays; the pairs are tried in capture order
    until one overwrites the first's output (the graphs share their pool, so
    a later capture's output may sit where an earlier one's intermediates
    run). Returns the readings; ``caught`` is both."""
    import numpy as np

    from deeplearning4j_tpu_torch.runtime import inference as inf

    graphs = [g for g in inf.served_graphs(net)
              if g.outputs is not None and g.outputs[0].dtype != torch.int32]
    full = next(g for g in graphs if g.inputs[0].shape[0] == x.shape[0])
    a, b = x, x[::-1].copy()
    full.load([a, None])
    full.load([b, None])
    full.execute()
    got_a = full.outputs[0].float().cpu().numpy()
    want_a, want_b = legacy(lambda: net.output(a)), legacy(lambda: net.output(b))
    reads_b = bool(np.array_equal(got_a, want_b) and not np.array_equal(got_a, want_a))
    overwritten = None
    for first, then in itertools.permutations(graphs, 2):
        rows_f, rows_t = first.inputs[0].shape[0], then.inputs[0].shape[0]
        first.load([x[:rows_f], None])
        first.execute()
        kept = first.outputs[0].clone()
        then.load([x[::-1][:rows_t].copy(), None])
        then.execute()
        if not torch.equal(first.outputs[0], kept):
            overwritten = {"kept_rows": int(rows_f), "replayed_rows": int(rows_t),
                           "max_abs_change": float((first.outputs[0].float()
                                                    - kept.float()).abs().max())}
            break
    return {"same_graph_reads_the_other_request": reads_b, "two_graphs_overwrite": overwritten,
            "caught": bool(reads_b and overwritten is not None)}


def char_rnn_graphs(torch, host_params, dtype, win):
    """The full-width char-RNN served: output at T=256 replayed against eager
    bit for bit, T=200 (bucket 256, the mask extended) against eager at
    T=200, the streaming state after a T=200 rnn_time_step against the eager
    stream's, STREAM_STEPS single steps at B=SLOTS bit for bit, no capture
    on a second pass, eager and replayed ms. The served calls are ``win``'s
    main path, the eager ones its yardstick. Returns (the net, readings)."""
    import numpy as np

    from deeplearning4j_tpu_torch import MultiLayerNetwork, char_rnn, load_jax_params
    from deeplearning4j_tpu_torch.runtime.compile_manager import get_compile_manager

    cm = get_compile_manager()
    conf = char_rnn(VOCAB, HIDDEN, LAYERS, dtype=dtype)
    net = load_jax_params(MultiLayerNetwork(conf), host_params)
    rng = np.random.default_rng(SEED + 21)
    x = one_hot(rng.integers(0, VOCAB, (BATCH, STEPS)), VOCAB)
    r = replayed_vs_eager(torch, net, x, (BATCH,), PADDED_REL[dtype], win)
    c0 = cm.compiles.value
    x200 = x[:, :CHAR_T_PADDED]
    got200, want200 = win.main(lambda: net.output(x200)), win.yard(lambda: net.output(x200))
    r["t200"] = {"rel_err": rel_err(got200, want200),
                 "bit_exact": bool(np.array_equal(got200, want200))}
    r["padded_ok"] = r["padded_ok"] and r["t200"]["rel_err"] <= PADDED_REL[dtype]

    def state_after(fn):
        net.rnn_clear_previous_state()
        fn()
        return [net.rnn_get_previous_state(i)[k].float().cpu().numpy()
                for i in range(LAYERS) for k in ("h", "c")]

    got_state = win.main(lambda: state_after(lambda: net.rnn_time_step(x200)))
    want_state = win.yard(lambda: state_after(lambda: net.rnn_time_step(x200)))
    r["state_t200"] = max(float(np.abs(g - w).max()) for g, w in zip(got_state, want_state))
    r["state_limit"] = SERVE_ATOL[dtype]
    toks = rng.integers(0, VOCAB, (STREAM_STEPS, SLOTS))

    def stream():
        net.rnn_clear_previous_state()
        return np.stack([net.rnn_time_step(one_hot(t, VOCAB)) for t in toks])

    got_stream, want_stream = win.main(stream), win.yard(stream)
    r["stream_bit_exact"] = bool(np.array_equal(got_stream, want_stream))
    warm = cm.compiles.value

    def again():
        net.output(x200)
        stream()
        net.rnn_clear_previous_state()
        net.rnn_time_step(x200)

    win.main(again)
    r["new_captures_after_warmup"] += cm.compiles.value - warm
    r["captures"] += warm - c0
    step = one_hot(toks[0], VOCAB)
    r["step_eager_ms"] = statistics.median(legacy(lambda: call_ms(
        torch, lambda: net.rnn_time_step(step), 20)))
    r["step_replayed_ms"] = statistics.median(call_ms(torch, lambda: net.rnn_time_step(step), 20))
    r["ok"] = bool(r["bit_exact"] and r["predict_exact"] and r["padded_ok"]
                   and r["state_t200"] <= r["state_limit"] and r["stream_bit_exact"]
                   and r["new_captures_after_warmup"] == 0)
    return net, r


def wrong_versions_graphs(torch, host_params, goog, x_goog) -> dict:
    """The wrong versions of serve_graphs, each against the right one:
    a hot swap that rebinds the params (the graphs read the old ones), an
    update whose bf16 casts are rebound (the graphs read the old casts),
    time padding without the extended mask (the padded steps move h/c), and
    replays without the lock (``unlocked_replays``)."""
    import numpy as np

    from deeplearning4j_tpu_torch import MultiLayerNetwork, char_rnn, load_jax_params
    from deeplearning4j_tpu_torch.nn import multilayer as ml
    from deeplearning4j_tpu_torch.runtime import inference as inf

    out = {}
    rng = np.random.default_rng(SEED + 22)
    x = one_hot(rng.integers(0, VOCAB, (BATCH, STEPS)), VOCAB)
    other = char_rnn_params(char_rnn(VOCAB, HIDDEN, LAYERS), SEED + 1)

    def swap_reading(rebind: bool) -> float:
        net = load_jax_params(MultiLayerNetwork(char_rnn(VOCAB, HIDDEN, LAYERS)), host_params)
        net.output(x)
        if rebind:  # the params replaced, not written into
            net.layer_params = torch.nn.ModuleList(net._param_dict(p) for p in other)
            net._compute_params = net._param_buffers = None
        else:
            net.swap_params(other)
        err = rel_err(net.output(x), legacy(lambda: net.output(x)))
        retire(torch, net)
        return err

    out["params_rebound_by_swap"] = {"right": swap_reading(False), "wrong": swap_reading(True)}

    y = np.roll(x, -1, axis=1)

    def update_reading(rebind: bool) -> float:
        # lr 0.1: the update moves the params well past bf16's rounding
        net = load_jax_params(MultiLayerNetwork(char_rnn(
            VOCAB, HIDDEN, LAYERS, learning_rate=0.1, dtype="bfloat16")), host_params)
        net.output(x)
        saved = ml.BaseNetwork._fill_param_buffers
        if rebind:
            def rebinding(self, casts):
                self._param_buffers = casts
                return casts
            ml.BaseNetwork._fill_param_buffers = rebinding
        try:
            net.fit((x[:8], y[:8]))
            err = rel_err(net.output(x), legacy(lambda: net.output(x)))
        finally:
            ml.BaseNetwork._fill_param_buffers = saved
        retire(torch, net)
        return err

    out["casts_rebound_by_update"] = {"right": update_reading(False),
                                      "wrong": update_reading(True)}

    def mask_reading(wrong: bool) -> float:
        net = load_jax_params(MultiLayerNetwork(char_rnn(VOCAB, HIDDEN, LAYERS)), host_params)
        x200 = x[:, :CHAR_T_PADDED]
        saved = inf._mask_for
        if wrong:
            inf._mask_for = lambda mask, *a: None if mask is None else saved(mask, *a)
        try:
            net.rnn_time_step(x200)
        finally:
            inf._mask_for = saved
        got = net.rnn_get_previous_state(LAYERS - 1)["h"].float().cpu().numpy()
        net.rnn_clear_previous_state()
        legacy(lambda: net.rnn_time_step(x200))
        want = net.rnn_get_previous_state(LAYERS - 1)["h"].float().cpu().numpy()
        retire(torch, net)
        return float(np.abs(got - want).max())

    out["padding_without_mask"] = {"right": mask_reading(False), "wrong": mask_reading(True)}
    lock = unlocked_replays(torch, goog, x_goog)
    limits = {"params_rebound_by_swap": PADDED_REL["float32"],
              "casts_rebound_by_update": 0.0, "padding_without_mask": SERVE_ATOL["float32"]}
    for k, lim in limits.items():
        out[k]["limit"] = lim
        out[k]["caught"] = bool(out[k]["right"] <= lim < out[k]["wrong"])
    # the right version is the locked path: each request alone, bit for bit
    right = bool(np.array_equal(goog.output(x_goog), legacy(lambda: goog.output(x_goog))))
    out["replay_without_lock"] = dict(lock, right_bit_exact=right,
                                      caught=bool(right and lock["caught"]))
    return out


def phase_serve_graphs(torch, goog_host, res_host, res_state, host_params, card):
    """GoogLeNet (B=128 and requests of SERVE_ROWS rows, f32 and bf16),
    ResNet-50 (B=128, no row padding, f32 and bf16) and the full-width
    char-RNN (B=64 at T=256 and 200, single steps at B=8; f32, and bf16
    at T=256) served through output(), predict() and rnn_time_step() on
    their default, replayed path, against the eager path: bit for bit at
    exact bucket shapes, within PADDED_REL when padded, the streaming state
    after a bucketed T=200 equal to eager's, no capture after warm-up;
    eager against replayed ms, captures and their seconds, the pools. Then
    the four wrong versions of ``wrong_versions_graphs``. Returns the
    launches of the served calls (wrapper counts, replayed), the readings
    and the eager yardstick's launches (``Windows``)."""
    from deeplearning4j_tpu_torch import googlenet_conf, resnet50_conf

    t0 = time.perf_counter()
    win = Windows(torch)
    readings = {}
    x_goog, _ = alexnet_images(GOOG_B, SEED + 8)
    keep = None
    for dtype in ("float32", "bfloat16"):
        net = googlenet_net(googlenet_conf(dtype=dtype), goog_host)
        r = replayed_vs_eager(torch, net, x_goog, SERVE_ROWS, PADDED_REL[dtype], win)
        r["ok"] = bool(r["bit_exact"] and r["predict_exact"] and r["padded_ok"]
                       and r["new_captures_after_warmup"] == 0)
        readings[f"googlenet_{dtype}"] = r
        if dtype == "float32":
            keep = net
        else:
            retire(torch, net)
    for dtype in ("float32", "bfloat16"):
        net = resnet_net(resnet50_conf(dtype=dtype), res_host, res_state)
        r = replayed_vs_eager(torch, net, x_goog, (RES_B,), PADDED_REL[dtype], win)
        r["ok"] = bool(r["bit_exact"] and r["predict_exact"]
                       and r["new_captures_after_warmup"] == 0 and not net._pad_examples_ok())
        readings[f"resnet50_{dtype}"] = r
        retire(torch, net)
    for dtype in ("float32", "bfloat16"):
        net, r = char_rnn_graphs(torch, host_params, dtype, win)
        readings[f"char_rnn_{dtype}"] = r
        retire(torch, net)
    faults = wrong_versions_graphs(torch, host_params, keep, x_goog)
    retire(torch, keep)
    replayed = win.replayed
    ok = (all(r["ok"] for r in readings.values()) and all(f["caught"] for f in faults.values())
          and replayed.get("lrn_fwd", 0) > 0 and replayed.get("lstm_seq_lean", 0) > 0
          and replayed.get("lstm_seq_lean_masked", 0) > 0)
    emit("serve_graphs", runs=readings, wrong_versions=faults, kernel_launches=win.launches,
         replayed_launches=replayed, yardstick_launches=win.yardstick,
         seconds=time.perf_counter() - t0, ok=ok, gpu=card)
    if not ok:
        raise AssertionError("the replayed serving path failed its checks")
    return win.launches, replayed, readings, win.yardstick


def decode_replayed_vs_eager(torch, net, eager_net, win) -> dict:
    """SLOTS sessions of DECODE_CHARS chars through a DecodeServer over
    ``net`` on the default path (every tick a replay: ``win``'s main path)
    against the same sessions through one over ``eager_net`` (the same
    weights) on the eager path (the yardstick): the same tokens, the rows
    within DECODE_ATOL, tokens/s of each from a second round (the first
    captures the tick's graph)."""
    import numpy as np

    from deeplearning4j_tpu_torch import DecodeServer
    from deeplearning4j_tpu_torch.runtime import inference as inf

    server = DecodeServer(net, capacity=SLOTS, max_delay_ms=2.0)
    eager = DecodeServer(eager_net, capacity=SLOTS, max_delay_ms=2.0)
    try:
        got, _ = win.main(lambda: decode_sessions(server))
        want, _ = win.yard(lambda: decode_sessions(eager))
        again, got_s = win.main(lambda: decode_sessions(server))
        want_again, want_s = win.yard(lambda: decode_sessions(eager))
    finally:
        server.stop()
        eager.stop()
    pairs = ((got, want), (again, want_again))
    same = all(np.array_equal(decode_tokens(a)[s], decode_tokens(b)[s])
               for a, b in pairs for s in a)
    err = max(float(np.abs(a[s] - b[s]).max()) for a, b in pairs for s in a)
    ticks = sum(g.replays for g in inf.served_graphs(net) if g.kind.endswith("rnn_step"))
    return {"same_tokens_as_eager": same, "max_abs_err_vs_eager": err, "atol": DECODE_ATOL,
            "ticks_replayed": ticks, "tokens_per_s": SLOTS * DECODE_CHARS / got_s,
            "eager_tokens_per_s": SLOTS * DECODE_CHARS / want_s,
            "ok": bool(same and err <= DECODE_ATOL and ticks > 0)}


def phase_serve_models(torch, host_params, alex_host, card):
    """The models the phases above serve eagerly, each through its default,
    replayed output() and predict() against the eager path (``replayed_vs_
    eager``, f32): the attention net and the MoE block (B=4, T=4096, and
    3 rows padded to 4), AlexNet (B=128, and 100 rows padded to 128), the
    fusedcell char-RNN and the graph char-RNN (B=64, T=256) with a decode
    through each against an eager server, and the sequence classifier
    (B=64, T=256, the ids' mask). Returns the launches of the served calls
    (wrapper counts, replayed), the readings and the yardstick's launches
    (``Windows``)."""
    import numpy as np

    from deeplearning4j_tpu_torch import (BucketingSequenceIterator, ComputationGraph,
                                          MultiLayerNetwork, alexnet_conf, char_rnn,
                                          load_jax_params)

    t0 = time.perf_counter()
    win = Windows(torch)
    readings = {}
    rng = np.random.default_rng(SEED + 25)
    x_attn = one_hot(rng.integers(0, VOCAB, (ATTN_B, ATTN_T)), VOCAB)
    x_char = one_hot(rng.integers(0, VOCAB, (BATCH, STEPS)), VOCAB)

    def check(name, net, x, rows, **kw):
        r = replayed_vs_eager(torch, net, x, rows, PADDED_REL["float32"], win, **kw)
        r["ok"] = bool(r["bit_exact"] and r["predict_exact"] and r["padded_ok"]
                       and r["new_captures_after_warmup"] == 0)
        readings[name] = r
        return r

    for name, conf, host in (("attention", attention_conf("float32"), attention_params(SEED)),
                             ("moe_attention", moe_attention_conf("float32"),
                              moe_attention_params(SEED))):
        net = load_jax_params(MultiLayerNetwork(conf), host)
        check(name, net, x_attn, (ATTN_B, ATTN_B - 1))
        retire(torch, net)
    net = load_jax_params(MultiLayerNetwork(alexnet_conf(dtype="float32")), alex_host)
    check("alexnet", net, alexnet_images(ALEX_B, SEED + 5)[0], (ALEX_B, 100))
    retire(torch, net)
    for name, make in (
            ("char_rnn_fusedcell", lambda: load_jax_params(MultiLayerNetwork(
                char_rnn(VOCAB, HIDDEN, LAYERS), lstm_variant="fusedcell"), host_params)),
            ("graph_char_rnn", lambda: load_jax_params(ComputationGraph(
                graph_char_rnn_conf("float32")), graph_host(host_params)))):
        net, eager_net = make(), make()
        r = check(name, net, x_char, (BATCH,))
        r["decode"] = decode_replayed_vs_eager(torch, net, eager_net, win)
        r["ok"] = r["ok"] and r["decode"]["ok"]
        retire(torch, net)
        retire(torch, eager_net)
    it = BucketingSequenceIterator(seq_sequences(96, 128, 256, SEED + 31), batch=BATCH,
                                   boundaries=RECIPE_BUCKETS)
    long_batch = next(ds for ds in it if ds.features.shape[1] == STEPS)
    net = load_jax_params(ComputationGraph(seq_classifier_conf()),
                          seq_classifier_params(SEED + 30))
    check("seq_classifier", net, np.asarray(long_batch.features), (BATCH,),
          masks=np.asarray(long_batch.features_mask, np.float32))
    retire(torch, net)
    replayed = win.replayed
    ok = (all(r["ok"] for r in readings.values())
          and all(replayed.get(k, 0) > 0 for (path, k, _) in SLICE21_ROWS
                  if path == "serve_models"))
    emit("serve_models", runs=readings, kernel_launches=win.launches,
         replayed_launches=replayed, yardstick_launches=win.yardstick,
         seconds=time.perf_counter() - t0, ok=ok, gpu=card)
    if not ok:
        raise AssertionError("a model served on the replayed path failed its checks")
    return win.launches, replayed, readings, win.yardstick


def service_requests(seed):
    """The distinct requests of the service phase: (model, offset, rows,
    argmax), GoogLeNet and the char-RNN, every SERVICE_ROWS row count from
    every SERVICE_STARTS offset, plain and argmax, in a seeded order."""
    import numpy as np

    plan = [(m, start, rows, argmax) for m in ("googlenet", "char_rnn")
            for start in SERVICE_STARTS for rows in SERVICE_ROWS for argmax in (False, True)]
    order = np.random.default_rng(seed).permutation(len(plan))
    return [plan[i] for i in order]


def decode_tokens(trajectories) -> dict:
    return {s: rows.argmax(-1) for s, rows in trajectories.items()}


def phase_serve_service(torch, goog_host, host_params, card):
    """GoogLeNet (f32) and the full-width char-RNN registered on one
    InferenceService (max_batch SERVICE_MAX_BATCH, 2 ms), both warmed up;
    SERVICE_THREADS clients send requests of mixed row counts (and argmax
    ones) drawn from ``service_requests`` for SERVICE_WINDOWS windows of
    SERVICE_WINDOW_S seconds each. Every result against its request's eager
    output() alone, stats() and the dl4jtpu_serve_* counters against the
    requests sent, no capture after warm-up; requests/s, p50 and p99 of
    each window and their spread, batch fill. Then decode: DECODE_ROUNDS
    rounds of SLOTS sessions x DECODE_CHARS chars through service.decoder
    (every tick a replay), each followed by the same round through an eager
    DecodeServer over the same weights: the tokens equal, tokens/s of each
    round of each; a slot reset that rebinds the state caught. Returns the
    launches of the served calls (wrapper counts, replayed), the readings
    and the eager yardstick's launches (``Windows``)."""
    import numpy as np

    from deeplearning4j_tpu_torch import (DecodeServer, InferenceService, MultiLayerNetwork,
                                          char_rnn, googlenet_conf, load_jax_params)
    from deeplearning4j_tpu_torch.runtime import inference as inf
    from deeplearning4j_tpu_torch.runtime.compile_manager import get_compile_manager
    from deeplearning4j_tpu_torch.serving import decode as sdecode
    from deeplearning4j_tpu_torch.telemetry import MetricsRegistry

    t0 = time.perf_counter()
    win = Windows(torch)
    cm = get_compile_manager()
    goog = googlenet_net(googlenet_conf(), goog_host)
    chars = load_jax_params(MultiLayerNetwork(char_rnn(VOCAB, HIDDEN, LAYERS)), host_params)
    nets = {"googlenet": goog, "char_rnn": chars}
    reg = MetricsRegistry()
    svc = InferenceService(registry=reg, max_delay_ms=2.0, max_batch=SERVICE_MAX_BATCH)
    pool = max(SERVICE_STARTS) + max(SERVICE_ROWS)
    x_goog, _ = alexnet_images(pool, SEED + 9)
    rng = np.random.default_rng(SEED + 23)
    x_char = one_hot(rng.integers(0, VOCAB, (pool, SERVICE_T)), VOCAB)
    inputs = {"googlenet": x_goog, "char_rnn": x_char}
    plan = service_requests(SEED + 24)
    wants = {(m, start, rows): win.yard(lambda m=m, start=start, rows=rows: nets[m].output(
        inputs[m][start:start + rows])) for m, start, rows, _ in plan}
    try:
        def warm():
            svc.register("googlenet", goog)
            svc.register("char_rnn", chars)
            svc.warmup("googlenet", x_goog[:1], argmax=True)
            svc.warmup("char_rnn", x_char[:1], argmax=True)

        warm_s = time.perf_counter()
        win.main(warm)
        warm_s = time.perf_counter() - warm_s
        c0 = cm.compiles.value
        errs, gaps = [], []
        sent = {"googlenet": [0, 0], "char_rnn": [0, 0]}
        windows = []

        def traffic():
            lats = [[] for _ in range(SERVICE_THREADS)]
            got = [[] for _ in range(SERVICE_THREADS)]
            deadline = time.perf_counter() + SERVICE_WINDOW_S

            def client(t):
                i = t * 7
                while time.perf_counter() < deadline:
                    model, start, rows, argmax = plan[i % len(plan)]
                    i += 1
                    s = time.perf_counter()
                    out = svc.predict(model, inputs[model][start:start + rows], argmax=argmax)
                    lats[t].append(time.perf_counter() - s)
                    got[t].append(((model, start, rows), argmax, out))

            wall = time.perf_counter()
            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(SERVICE_THREADS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            return time.perf_counter() - wall, [x for l in lats for x in l], \
                [x for g in got for x in g]

        for _ in range(SERVICE_WINDOWS):
            wall, lat, got = win.main(traffic)
            for key, argmax, out in got:
                want = wants[key]
                sent[key[0]][0] += 1
                sent[key[0]][1] += key[2]
                if argmax:
                    top = np.take_along_axis(want, out[..., None].astype(np.int64), -1)[..., 0]
                    gaps.append(float((want.max(-1) - top).max() / want.max()))
                else:
                    errs.append(rel_err(out, want))
            windows.append({"requests": len(got), "seconds": wall,
                            "requests_per_s": len(got) / wall,
                            "client_p50_ms": float(np.percentile(lat, 50) * 1e3),
                            "client_p99_ms": float(np.percentile(lat, 99) * 1e3)})
        new_captures = cm.compiles.value - c0
        stats = svc.stats()
        counters_ok = all(
            stats["models"][m]["requests_total"] == n
            and stats["models"][m]["rows_total"] == rows
            and reg.get("dl4jtpu_serve_requests_total").labels(model=m).value == n
            and reg.get("dl4jtpu_serve_rows_total").labels(model=m).value == rows
            and reg.get("dl4jtpu_serve_latency_seconds").labels(model=m).count == n
            and stats["models"][m]["batches_total"] <= n
            for m, (n, rows) in sent.items())

        def spread(key):
            vals = [w[key] for w in windows]
            return {"median": statistics.median(vals), "min": min(vals), "max": max(vals)}

        traffic_readings = {
            "windows": windows, "window_seconds": SERVICE_WINDOW_S,
            "requests": sum(w["requests"] for w in windows),
            "requests_per_s": spread("requests_per_s"),
            "client_p50_ms": spread("client_p50_ms"), "client_p99_ms": spread("client_p99_ms"),
            "models": {m: {"requests": sent[m][0],
                           "p50_ms": stats["models"][m]["latency_seconds"]["p50"] * 1e3,
                           "p99_ms": stats["models"][m]["latency_seconds"]["p99"] * 1e3,
                           "batches": stats["models"][m]["batches_total"],
                           "mean_batch_fill_ratio": stats["models"][m]["mean_batch_fill_ratio"]}
                       for m in sent},
            "warmup_s": warm_s, "new_captures_after_warmup": new_captures,
            "max_rel_err": max(errs), "limit": PADDED_REL["float32"],
            "argmax_worst_gap": max(gaps), "counters_ok": counters_ok}
        traffic_ok = (new_captures == 0 and counters_ok and max(errs) <= PADDED_REL["float32"]
                      and max(gaps) <= PADDED_REL["float32"])

        # decode: the service's decoder (replayed ticks) and an eager server
        # over the same weights, round by round in turn
        dec = svc.decoder("char_rnn")
        eager_net = load_jax_params(MultiLayerNetwork(char_rnn(VOCAB, HIDDEN, LAYERS)),
                                    host_params)
        eager = DecodeServer(eager_net, capacity=SLOTS, max_delay_ms=2.0)
        rounds, eager_rounds = [], []
        try:
            for _ in range(DECODE_ROUNDS):
                rounds.append(win.main(lambda: decode_sessions(dec)))
                eager_rounds.append(win.yard(lambda: decode_sessions(eager)))
        finally:
            eager.stop()
        tick_graphs = [g for g in inf.served_graphs(chars) if g.kind == "mln_rnn_step"]
        ticks_replayed = sum(g.replays for g in tick_graphs)
        tick_replay_ms = median_ms(tick_graphs[0].execute, reps=20)  # the sessions are closed
        same = all(np.array_equal(decode_tokens(r[0])[s], decode_tokens(e[0])[s])
                   for r, e in zip(rounds, eager_rounds) for s in r[0])
        dec_err = max(float(np.abs(r[0][s] - e[0][s]).max())
                      for r, e in zip(rounds, eager_rounds) for s in r[0])
        tok = SLOTS * DECODE_CHARS
        rates = [tok / r[1] for r in rounds]
        eager_rates = [tok / e[1] for e in eager_rounds]
        decode = {"sessions": SLOTS, "chars_each": DECODE_CHARS, "rounds": DECODE_ROUNDS,
                  "ticks_replayed": ticks_replayed,
                  "tokens_per_s": statistics.median(rates),
                  "eager_tokens_per_s": statistics.median(eager_rates),
                  "tokens_per_s_runs": rates, "eager_tokens_per_s_runs": eager_rates,
                  "replayed_over_eager_by_round": [a / b for a, b in zip(rates, eager_rates)],
                  "ticks": dec.ticks, "eager_ticks": eager.ticks,
                  "tick_ms": sum(r[1] for r in rounds) / dec.ticks * 1e3,
                  "eager_tick_ms": sum(e[1] for e in eager_rounds) / eager.ticks * 1e3,
                  "tick_replay_alone_ms": tick_replay_ms,
                  "same_tokens_as_eager": same, "max_abs_err_vs_eager": dec_err,
                  "atol": DECODE_ATOL}

        # the wrong version: a slot reset that zeroes a copy and rebinds it
        saved = DecodeServer._reset_slot

        def rebinding_reset(self, slot):
            with self._net_lock:
                if self.net._rnn_state is None:
                    return
                fresh = tuple({k: v.clone() for k, v in d.items()} for d in self.net._rnn_state)
                for t in sdecode._state_tensors(fresh):
                    t[slot].zero_()
                self.net._rnn_state = fresh

        wrong_net = load_jax_params(MultiLayerNetwork(char_rnn(VOCAB, HIDDEN, LAYERS)),
                                    host_params)
        DecodeServer._reset_slot = rebinding_reset
        wrong = DecodeServer(wrong_net, capacity=SLOTS, max_delay_ms=2.0)
        try:
            wrong_rounds = [decode_sessions(wrong) for _ in range(2)]
        finally:
            wrong.stop()
            DecodeServer._reset_slot = saved
        wrong_same = all(np.array_equal(decode_tokens(r[0])[s], decode_tokens(e[0])[s])
                         for r, e in zip(wrong_rounds, eager_rounds) for s in r[0])
        decode["slot_reset_rebinds_state"] = {"same_tokens_as_eager": wrong_same,
                                              "caught": not wrong_same}
        decode_ok = (same and dec_err <= DECODE_ATOL and ticks_replayed > 0
                     and not wrong_same)
        retire(torch, wrong_net)
        retire(torch, eager_net)
    finally:
        svc.stop()
    replayed = win.replayed
    ok = traffic_ok and decode_ok and replayed.get("lstm_seq_lean_masked", 0) > 0 \
        and replayed.get("lrn_fwd", 0) > 0
    emit("serve_service", traffic=traffic_readings, decode=decode, kernel_launches=win.launches,
         replayed_launches=replayed, yardstick_launches=win.yardstick,
         compile_cache=cm.stats(), seconds=time.perf_counter() - t0, ok=ok, gpu=card)
    retire(torch, goog)
    retire(torch, chars)
    if not ok:
        raise AssertionError("the serving front failed its checks")
    return win.launches, replayed, {"traffic": traffic_readings, "decode": decode}, \
        win.yardstick


def phases_slice21(torch, card, goog_host, res_host, res_state, host_params, alex_host):
    """Slice 21's phases on the default (replayed) serving path. Returns,
    by path, the launches of the main path's own calls (wrapper counts,
    replayed), the readings and the eager yardstick's launches."""
    launches, replayed, readings, yardstick = {}, {}, {}, {}
    t0 = time.perf_counter()
    for path, run in (
            ("serve_graphs", lambda: phase_serve_graphs(torch, goog_host, res_host, res_state,
                                                        host_params, card)),
            ("serve_models", lambda: phase_serve_models(torch, host_params, alex_host, card)),
            ("serve_service", lambda: phase_serve_service(torch, goog_host, host_params, card))):
        launches[path], replayed[path], readings[path], yardstick[path] = run()
    readings["seconds"] = time.perf_counter() - t0
    return launches, replayed, readings, yardstick


def kernels_slice21(torch, ls, lr, card) -> dict:
    """Rows 3 and 5 at the shapes slice 21's graphs launch them that no
    earlier row holds: GoogLeNet's two LRN serving forwards and AlexNet's
    first (y alone), the lean sequence masked at T=256 B=64 (a T=200
    request bucketed) and unmasked at T=1 B=8 (single steps), each against
    its plain version on
    the same tensors, then timed beside it, its bound and (LRN)
    F.local_response_norm's forward. Returns {(path, kernel, shape name):
    (max abs err, times, shape)}."""
    import torch.nn.functional as F

    out = {}
    args = (LRN_K, LRN_N, LRN_ALPHA, LRN_BETA)
    lrn_rows = [("serve_graphs", where, shape) for where, shape in GOOG_LRN_SHAPES.items()]
    lrn_rows.append(("serve_models", "lrn1", LRN_SHAPES["lrn1"]))  # AlexNet's first LRN
    for path, where, shape in lrn_rows:
        x, _ = lrn_inputs(torch, shape, "float32", SEED + 21)
        y, _ = lr.lrn_forward(x, *args, with_d=False)
        ry, _ = lr.lrn_reference(x, *args)
        b_ms, b_by = bound_lrn(shape, "float32", False, with_d=False)
        times = time_pair(
            torch, "lrn_fwd", lambda: lr.lrn_forward(x, *args, with_d=False),
            lambda: lr.lrn_reference(x, *args),
            lambda: F.local_response_norm(x.permute(0, 3, 1, 2), LRN_N, alpha=LRN_ALPHA * LRN_N,
                                          beta=LRN_BETA, k=LRN_K),
            b_ms, b_by, card, dtype="float32", layer=where, shape=list(shape),
            where="slice 21's graphs, y alone")
        out[(path, "lrn_fwd", where)] = (
            float((y - ry).abs().max()), times, f"{list(shape)}, y alone")
    for name, T, B, masked in (("lstm_seq_lean_masked", STEPS, BATCH, True),
                               ("lstm_seq_lean", 1, SLOTS, False)):
        a = seq_inputs(torch, T, B, HIDDEN, "float32", masked, SEED + 21)
        kern = (lambda: ls.fused_lstm_sequence_masked(*a)) if masked else \
            (lambda: ls.fused_lstm_sequence(*a))
        plain = (lambda: ls.lstm_sequence_masked_reference(*a)) if masked else \
            (lambda: ls.lstm_sequence_reference(*a))
        got, want = kern(), plain()
        got = got if isinstance(got, (list, tuple)) else (got,)
        want = want if isinstance(want, (list, tuple)) else (want,)
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        b_ms, b_by = bound(T, B, HIDDEN, "float32", masked, live_share(a[1]) if masked else 1.0)
        times = time_pair(torch, name, kern, plain, None, b_ms, b_by, card, dtype="float32",
                          T=T, B=B, H=HIDDEN, where="slice 21's graphs")
        out[("serve_graphs", name, f"T={T} B={B}")] = (err, times, f"T={T} B={B} H={HIDDEN}")
    return out


# ---- slice 22: runtime durability and online learning. The char-RNN at
# full width trained online by OnlineTrainer from a record stream
# (QueueSource fed by a producer thread, through ReplayBufferSource(
# ChaosSource(...)) under a seeded FaultPlan: two source outages, one NaN
# burst), a CheckpointStore version every 8 updates, each hot-swapped into
# an InferenceService that four clients use the whole time; a rollback on
# the NaN burst with its poisoned-span replay. Everything it launches but
# the replay's no-update loss runs inside replayed CUDA graphs.
ONLINE_BATCH, ONLINE_STAGE = 64, 4
ONLINE_BLOCK = ONLINE_BATCH * ONLINE_STAGE  # records of one time bucket in a row: a full window
ONLINE_LENGTHS = ((64, 128), (129, 256))  # ragged record lengths: time buckets 128 and 256
ONLINE_BLOCKS = 14  # blocks of the traffic after the warm blocks (one of each bucket)
ONLINE_CKPT_EVERY, ONLINE_RETAIN = 8, 3
ONLINE_CLIENTS, ONLINE_CLIENT_ROWS, ONLINE_CLIENT_T = 4, (1, 8), 128
ONLINE_SERVE_MAX_BATCH = 32  # the clients' coalesced rows stay within the warmed buckets
ONLINE_WINDOW_S = 4.0  # the clients' idle window, and the training window of the same length
ONLINE_DEADLINE_S = 60.0  # the phase's traffic stops here whatever the record count
ONLINE_BARE_WINDOWS = 6  # windows of the path kept for the bare fit_on_device yardstick
# the seeded fault plan: outages at these source polls (4 polls down each),
# a NaN burst of ONLINE_NAN_RECORDS records from this record on
ONLINE_OUTAGE_POLLS = (3 * ONLINE_BLOCK, 9 * ONLINE_BLOCK)
ONLINE_NAN_AT, ONLINE_NAN_RECORDS = 6 * ONLINE_BLOCK + 10, 8
# rows of the path: (kernel, shape name) -> the main row whose shape it
# is, or None where kernels_slice22 holds and times it at this shape
SLICE22_ROWS = {
    ("lstm_seq_lean", "T=128 B=8"): None,
    ("lstm_seq_masked_train_fwd", "T=256 B=64"): "lstm_seq_masked_train_fwd",
    ("lstm_seq_masked_train_fwd", "T=128 B=64"): None,
    ("lstm_seq_masked_bwd", "T=256 B=64"): "lstm_seq_masked_bwd",
    ("lstm_seq_masked_bwd", "T=128 B=64"): None,
    ("drw_product", "T=256 B=64"): "drw_product",
    ("drw_product", "T=128 B=64"): None,
    ("softmax_xent_fwd", "T=256 B=64"): "softmax_xent_fwd",
    ("softmax_xent_fwd", "T=128 B=64"): None,
    ("softmax_xent_bwd", "T=256 B=64"): "softmax_xent_bwd",
    ("softmax_xent_bwd", "T=128 B=64"): None,
    ("adam_update_dev", "14 leaves"): "adam_update_dev",
}


def online_plan():
    from deeplearning4j_tpu_torch.testing import FaultPlan

    return FaultPlan(SEED, [
        {"site": "source.poll", "fault": "source-error", "at": list(ONLINE_OUTAGE_POLLS),
         "params": {"polls": 4}},
        {"site": "source.record", "fault": "nan-burst", "at": [ONLINE_NAN_AT],
         "params": {"records": ONLINE_NAN_RECORDS}}])


def online_block(rng, long: bool):
    """ONLINE_BLOCK next-char records ([T, VOCAB] one-hot features and
    labels) of ragged lengths in one of ONLINE_LENGTHS."""
    import numpy as np

    lo, hi = ONLINE_LENGTHS[int(long)]
    eye = np.eye(VOCAB, dtype=np.float32)
    out = []
    for t in rng.integers(lo, hi + 1, ONLINE_BLOCK):
        ids = rng.integers(0, VOCAB, int(t) + 1)
        out.append((eye[ids[:-1]], eye[ids[1:]]))
    return out


def step_marks() -> dict:
    """Every live captured training step and its replays so far, by id."""
    from deeplearning4j_tpu_torch.runtime.compile_manager import get_compile_manager
    from deeplearning4j_tpu_torch.runtime.step_graphs import StepGraph

    return {id(g): (g, g.replays) for _, g in get_compile_manager().owned()
            if isinstance(g, StepGraph)}


def step_replayed_since(marks: dict, by_t: dict) -> dict:
    """What the captured steps launched by replay since ``marks`` (one
    replay's launches times the replays since), also into ``by_t`` by the
    step's time bucket."""
    graphs = {k: g for k, (g, _) in marks.items()}
    graphs.update({k: g for k, (g, _) in step_marks().items()})
    out: dict = {}
    for k, g in graphs.items():
        seen = marks.get(k)
        n = g.replays - (seen[1] if seen is not None and seen[0] is g else 0)
        counts = {name: v * n for name, v in g.launches.items()}
        add_counts(out, counts)
        t = int(g.batch[0].shape[1]) if g.batch[0].dim() == 3 else None
        add_counts(by_t.setdefault(t, {}), counts)
    return out


def pct(values, q):
    import numpy as np

    return float(np.percentile(values, q)) if values else None


def phase_online_char_rnn(torch, host_params, card):
    """The char-RNN (char_rnn(96, 512, 2), Adam, standard backprop, as the
    staged recipe sets it) trained online on the default, replayed path:
    micro-batches of ONLINE_BATCH records, windows of ONLINE_STAGE, ragged
    records of 64-256 steps in blocks of one time bucket (128 or 256), a
    version every ONLINE_CKPT_EVERY updates into a CheckpointStore of
    ONLINE_RETAIN, each hot-swapped into an InferenceService that
    ONLINE_CLIENTS clients use the whole time with requests of 1-8 rows of
    T=128. The FaultPlan injects two outages and one NaN burst. Holds: the
    trainer alive and reconnected after each outage, a rollback with its
    replay and a flight bundle, no capture after the warm-up (the first
    window of each family and the service's buckets) through the swaps and
    the rollback, no failed request, the served output after the last swap
    equal bit for bit to a restore of the newest version, the first
    window's losses equal to a clone's fit_on_device over the same window,
    a corrupted version quarantined with load_into falling back, and rows
    5 and 8-12 launching. Returns (launches, launches by time bucket,
    readings, the masks of a 128 window's batch)."""
    import tempfile
    import threading

    import numpy as np

    from deeplearning4j_tpu_torch import (InferenceService, MultiLayerNetwork, char_rnn,
                                          load_jax_params, ops)
    from deeplearning4j_tpu_torch.runtime import CheckpointStore, OnlineTrainer
    from deeplearning4j_tpu_torch.runtime.compile_manager import get_compile_manager
    from deeplearning4j_tpu_torch.streaming import QueueSource, ReplayBufferSource
    from deeplearning4j_tpu_torch.telemetry import MetricsRegistry
    from deeplearning4j_tpu_torch.telemetry.flight_recorder import (FlightRecorder,
                                                                    set_flight_recorder)
    from deeplearning4j_tpu_torch.testing import ChaosSource, corrupt_file

    t_phase = time.perf_counter()
    conf = char_rnn(VOCAB, HIDDEN, LAYERS)
    assert (conf.updater["updater"], conf.updater["learning_rate"]) == ("adam", RECIPE_LR)
    conf.backprop_type = "standard"
    net = load_jax_params(MultiLayerNetwork(conf), host_params)
    ref = net.clone()  # the same weights: the first window's and the bare yardstick's
    tmp = tempfile.mkdtemp(prefix="dl4jtpu_online_")
    recorder = FlightRecorder(dump_dir=os.path.join(tmp, "flight"), registry=MetricsRegistry())
    set_flight_recorder(recorder)
    reg = MetricsRegistry()
    store = CheckpointStore(os.path.join(tmp, "ckpt"), retain=ONLINE_RETAIN, registry=reg)
    svc = InferenceService(registry=reg, max_delay_ms=2.0, max_batch=ONLINE_SERVE_MAX_BATCH)
    queue = QueueSource(maxsize=2 * ONLINE_BLOCK)
    plan = online_plan()
    chaos = ChaosSource(queue, plan)
    trainer = OnlineTrainer(net, ReplayBufferSource(chaos), batch=ONLINE_BATCH,
                            stage=ONLINE_STAGE, linger=0.05, name="online_char_rnn",
                            checkpoint_store=store, checkpoint_every_steps=ONLINE_CKPT_EVERY,
                            service=svc, serve_as="char_rnn_live", registry=reg,
                            source_retry_s=0.02)
    cm = get_compile_manager()
    # ---- instruments: per-window ms, the first windows' tensors, the
    # snapshot, the writer, swaps and rollbacks
    readings = {"window_ms": [], "snapshot_ms": [], "write_s": [], "swap_ms": [],
                "rollback_ms": [], "load_into_ms": []}
    kept, first_losses, mask128 = [], [], []
    real_fit = net.fit_on_device

    def fit_spy(xs, ys, steps=None, features_masks=None, labels_masks=None, real_batches=None):
        t0 = time.perf_counter()
        losses = real_fit(xs, ys, steps=steps, features_masks=features_masks,
                          labels_masks=labels_masks, real_batches=real_batches)
        readings["window_ms"].append((time.perf_counter() - t0) * 1e3)
        if len(kept) < ONLINE_BARE_WINDOWS:
            kept.append((xs, ys, features_masks, labels_masks, real_batches))
            if not first_losses:
                first_losses.append(np.array(losses))
        if not mask128 and xs.shape[2] == 128:
            mask128.append(features_masks[0].t().contiguous()[:, :, None])
        return losses

    net.fit_on_device = fit_spy

    def timed(key, fn, scale=1e3):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                readings[key].append((time.perf_counter() - t0) * scale)
        return run

    real_snapshot = CheckpointStore.snapshot
    CheckpointStore.snapshot = staticmethod(timed("snapshot_ms", real_snapshot))
    store._write = timed("write_s", store._write, scale=1.0)
    svc.hot_swap = timed("swap_ms", svc.hot_swap)
    trainer._rollback = timed("rollback_ms", trainer._rollback)
    store.load_into = timed("load_into_ms", store.load_into)

    rng = np.random.default_rng(SEED)
    x_req = one_hot(rng.integers(0, VOCAB, (ONLINE_SERVE_MAX_BATCH, ONLINE_CLIENT_T)), VOCAB)
    lats, errors, stop_clients = [], [], threading.Event()

    def client(c):
        r = np.random.default_rng(SEED + 100 + c)
        while not stop_clients.is_set():
            rows = int(r.integers(ONLINE_CLIENT_ROWS[0], ONLINE_CLIENT_ROWS[1] + 1))
            start = int(r.integers(0, ONLINE_SERVE_MAX_BATCH - rows + 1))
            t0 = time.perf_counter()
            try:
                out = svc.predict("char_rnn_live", x_req[start:start + rows], timeout_s=60)
                if out.shape != (rows, ONLINE_CLIENT_T, VOCAB) or not np.isfinite(out).all():
                    errors.append(f"bad result {out.shape}")
            except Exception as e:  # noqa: BLE001 - every failure is reported
                errors.append(f"{type(e).__name__}: {e}"[:200])
            lats.append((time.perf_counter(), (time.perf_counter() - t0) * 1e3))

    def wait_for(pred, seconds):
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            if pred():
                return True
            time.sleep(0.01)
        return False

    clients = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(ONLINE_CLIENTS)]
    produced = [0]

    def produce(blocks, start_long):
        for b in range(blocks):
            for rec in online_block(rng_prod, (b + start_long) % 2 == 1):
                queue.put(*rec, timeout=120)
                produced[0] += 1

    rng_prod = np.random.default_rng(SEED + 7)
    ops.reset_counters()
    marks, smarks = replay_marks(), step_marks()
    try:
        # ---- start: the service serves the trainer's clone; its buckets warm
        trainer.start()
        svc.warmup("char_rnn_live", x_req[:1], max_rows=ONLINE_SERVE_MAX_BATCH)
        # ---- the idle window: clients, no training
        for th in clients:
            th.start()
        t_idle = time.perf_counter()
        time.sleep(ONLINE_WINDOW_S)
        idle = [ms for t, ms in lats if t > t_idle]
        # ---- warm: one window of each family (128, then 256)
        produce(2, 0)
        assert wait_for(lambda: trainer.stats()["windows_total"] >= 2, 120), trainer.stats()
        warm_kinds = sorted(cm.kinds(net._cm_token))
        c0 = cm.compiles.value
        # ---- the traffic, while the clients run
        t_train = time.perf_counter()
        steps0, records0 = trainer.stats()["steps_total"], trainer.stats()["records_total"]
        producer = threading.Thread(target=produce, args=(ONLINE_BLOCKS, 0), daemon=True)
        producer.start()
        end = t_train + ONLINE_DEADLINE_S
        while producer.is_alive() and time.perf_counter() < end:
            time.sleep(0.05)
        drained = wait_for(lambda: trainer.stats()["records_total"] >= produced[0],
                           max(5.0, end - time.perf_counter()))
        # the last partial group flushes once the stream goes idle
        windows = trainer.stats()["windows_total"]
        wait_for(lambda: trainer.stats()["windows_total"] > windows, 2.0)
        train_s = time.perf_counter() - t_train
        stats = trainer.stats()
        alive = trainer.alive
        final_version = trainer.checkpoint_now(swap=True)
        store.join()
        stop_clients.set()
        for th in clients:
            th.join(60)
        producer.join(10)
        captures_after_warm = cm.compiles.value - c0
        busy = [ms for t, ms in lats if t_train < t <= t_train + ONLINE_WINDOW_S]
        training = [ms for t, ms in lats if t_train < t <= t_train + train_s]
        # ---- the served output after the last swap against a restore of it
        probe = x_req[:8]
        served = svc.predict("char_rnn_live", probe, timeout_s=60)
        torch.cuda.synchronize()
        counts = ops.counters()
        by_t: dict = {}
        replayed = add_counts(replayed_since(marks), step_replayed_since(smarks, by_t))
        served_replays = replayed_since(marks)
        restored = store.restore(final_version)
        served_vs_restored = float(np.abs(served - restored.output(probe)).max())
        trainer.stop(checkpoint=False)
        svc.stop()
    finally:
        stop_clients.set()
        CheckpointStore.snapshot = real_snapshot
        set_flight_recorder(None)
    # ---- the first window against a clone's fit_on_device, then the bare yardstick
    torch.cuda.synchronize()
    first = ref.fit_on_device(*kept[0][:2], steps=kept[0][4], features_masks=kept[0][2],
                              labels_masks=kept[0][3], real_batches=kept[0][4])
    first_equal = bool(np.array_equal(first, first_losses[0]))
    for w in kept[1:]:  # captures ref's other family
        ref.fit_on_device(*w[:2], steps=w[4], features_masks=w[2], labels_masks=w[3],
                          real_batches=w[4])
    bare_ms = []
    for w in kept:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref.fit_on_device(*w[:2], steps=w[4], features_masks=w[2], labels_masks=w[3],
                          real_batches=w[4])
        bare_ms.append((time.perf_counter() - t0) * 1e3)
    rollback_load_ms = list(readings["load_into_ms"])
    # ---- a corrupted version is quarantined and load_into falls back
    versions = [v.version for v in store.versions()]
    corrupt_file(store.path(versions[-1]), seed=SEED)
    fell_back_to = store.load_into(restored)
    quarantined = os.path.exists(store.path(versions[-1]) + ".quarantine")
    bundles = list(recorder.dumps)
    version_bytes = os.path.getsize(store.path(fell_back_to))
    on_path = {k: counts.get(k, 0) + replayed.get(k, 0) for k in
               ("lstm_seq_lean", "lstm_seq_masked_train_fwd", "lstm_seq_masked_bwd",
                "drw_product", "softmax_xent_fwd", "softmax_xent_bwd", "adam_update_dev")}
    last = stats["last_replay"] or {}
    records = stats["records_total"] - records0
    readings.update(
        records_total=stats["records_total"], steps_total=stats["steps_total"],
        windows_total=stats["windows_total"], train_s=train_s, drained=drained,
        records_per_s=records / train_s, window_ms_median=statistics.median(
            readings["window_ms"][2:] or readings["window_ms"]),
        bare_window_ms=bare_ms, bare_window_ms_median=statistics.median(bare_ms),
        snapshot_ms_median=statistics.median(readings["snapshot_ms"]),
        write_s_median=statistics.median(readings["write_s"]), version_bytes=version_bytes,
        swap_ms_median=statistics.median(readings["swap_ms"]),
        rollback_load_into_ms=rollback_load_ms,
        client_ms={"idle": {"n": len(idle), "p50": pct(idle, 50), "p99": pct(idle, 99)},
                   "training_window": {"n": len(busy), "p50": pct(busy, 50),
                                       "p99": pct(busy, 99)},
                   "training_all": {"n": len(training), "p50": pct(training, 50),
                                    "p99": pct(training, 99)},
                   "window_s": ONLINE_WINDOW_S},
        client_errors=errors[:5], rollbacks=stats["rollbacks_total"],
        replays=stats["replays_total"], last_replay_outcome=last.get("outcome"),
        last_replay_records=last.get("records"), outages=chaos.outages,
        reconnects=stats["reconnects_total"], source_errors=stats["source_errors_total"],
        nan_records=chaos.nan_records, swaps=stats["swaps_total"],
        final_version=final_version, versions_after=versions, fell_back_to=fell_back_to,
        quarantined=quarantined, flight_bundles=len(bundles), alive=alive,
        captures_after_warm=captures_after_warm, warm_kinds=warm_kinds,
        served_vs_restored_max_abs=served_vs_restored, first_window_equal=first_equal,
        first_window_losses=first_losses[0].tolist(), on_path=on_path,
        served_replayed=served_replays, wrapper_counts={k: v for k, v in counts.items() if v},
        seconds=time.perf_counter() - t_phase, faults=plan.summary()["fired"])
    checks = {
        "alive": bool(alive), "outages": chaos.outages == len(ONLINE_OUTAGE_POLLS),
        "reconnected": stats["reconnects_total"] >= chaos.outages,
        "rolled_back": stats["rollbacks_total"] >= 1, "replayed": stats["replays_total"] >= 1,
        "bundle": bool(bundles), "no_capture_after_warm": captures_after_warm == 0,
        "no_failed_request": not errors, "served_equals_restore": served_vs_restored == 0.0,
        "first_window_equal": first_equal, "quarantined": quarantined,
        "fell_back": fell_back_to == versions[-2],
        "rows_launched": all(on_path.values())}
    ok = all(checks.values())
    readings["checks"] = checks
    emit("online_char_rnn", gpu=card, ok=bool(ok), **{
        k: v for k, v in readings.items() if k not in ("window_ms", "snapshot_ms", "write_s",
                                                        "swap_ms")},
         window_ms_runs=readings["window_ms"], snapshot_ms_runs=readings["snapshot_ms"],
         write_s_runs=readings["write_s"], swap_ms_runs=readings["swap_ms"])
    if not ok:
        raise AssertionError("online_char_rnn failed its checks: "
                             f"{[k for k, v in checks.items() if not v]}")
    return on_path, by_t, readings, mask128[0]


def kernels_slice22(torch, ls, sx, card, mask128) -> dict:
    """Rows 5 and 8-11 at the shapes the online path gives them that no
    earlier row holds: the lean sequence at T=128 B=8 (a served bucket of
    the clients' requests), the masked training forward, backward and dRW
    at T=128 B=64 with the mask of a batch of the path's 128 windows, and
    softmax-xent at N=8192 C=96, each against its plain version on the same
    tensors, then timed beside it, its bound and the library call. Returns
    {(kernel, shape name): (max abs err, times, shape)}."""
    out = {}
    err, t = lean_at(torch, ls, ONLINE_CLIENT_T, 8, HIDDEN, card, "online_char_rnn")
    out[("lstm_seq_lean", "T=128 B=8")] = (err, t, f"T=128 B=8 H={HIDDEN}")
    rows = lstm_rows_at(torch, ls, 128, ONLINE_BATCH, HIDDEN, card, "online_char_rnn",
                        mask=mask128.to(DEVICE, torch.float32))
    for name, (e, t) in rows.items():
        out[(name, "T=128 B=64")] = (e, t, f"T=128 B=64 H={HIDDEN}, the path's mask"
                                     + (" R=8192" if name == "drw_product" else ""))
    N = 128 * ONLINE_BATCH
    e = sxent_case(torch, sx, N, VOCAB, "float32", "one_hot", SEED + 22)
    for (k, _), t in time_sxent(torch, sx, N, VOCAB, ("float32",), card,
                                "the online path's T=128 windows").items():
        out[(k, "T=128 B=64")] = (e["loss"] if k.endswith("fwd") else max(e["dx"], e["dl"]),
                                  t, f"N={N} C={VOCAB}")
    return out


# ---- slice 23: the training UI and its host tier. LeNet (lenet_mnist_conf()
# at its own widths, B=64) trained from MNIST-sized IDX files (written here
# from the seed: class patterns with noise) through the C++ loader, under
# StatsListener (into SQLite), ConvolutionalIterationListener and
# ProfilingListener; watched through UIServer; served over POST
# /serving/predict by the InferenceService on its default, replayed path;
# its 500-wide penultimate features embedded by exact t-SNE and clustered by
# k-means on the card. Rows 10-12.
UI_B = 64
UI_SPLITS = {"train": 60000, "t10k": 10000}  # MNIST's IDX files, 28x28 uint8
UI_UPDATES = 40  # one epoch of the loader over the first UI_B * UI_UPDATES training images
UI_COMPARED = 4  # updates held against the port on the CPU over the same batches
UI_PROFILE = {"start": 10, "duration": 5}  # the ProfilingListener's window of updates
UI_CONV_EVERY = 10
UI_TIMED = 20  # timed updates a listener setting, in turns: none, every 1, every 10, and back
UI_HTTP = {"clients": 4, "requests": 16, "rows": 8}  # requests/s over HTTP
UI_TSNE_N = 2500  # held-out images whose penultimate features t-SNE embeds
UI_TSNE_COMPARED = 3  # t-SNE iterations held against the CPU's
UI_KMEANS_K = 10
UI_KNN = 10
# Limits. Losses: the MNIST rows' (RECIPE_LIMITS f32). Served rows against
# the net's own output(): PADDED_REL. t-SNE's first iterations against the
# CPU's: the largest coordinate difference over the embedding's largest
# coordinate (the step is chaotic: float32 against float64 part by the
# embedding's size within 20 iterations, so only the first few are held);
# a flipped gains rule moves the first step by 1.2/0.8. k-means, against
# the CPU's run of as many iterations as the card's: the same assignment but
# at ties (the two centers' squared distances within
# KMEANS_TIE of |x|^2 + max |c|^2, f32's rounding of them), the
# inertia within its limit. The final embedding: the share of
# each point's UI_KNN nearest neighbours with its label.
UI_LIMITS = {"loss_rel": MNIST_LIMITS["loss_rel"], "served_rel": PADDED_REL["float32"],
             "tsne_rel": 1e-3, "kmeans_inertia_rel": 1e-4, "tsne_knn_agreement": 0.8}
KMEANS_TIE = 1e-5
UI_FAULTS = ("loader_repeats_a_batch", "epoch_not_reshuffled", "mean_magnitude_without_abs",
             "tsne_gains_sign_flipped", "served_by_another_model")
# JAX's top-level keys of the endpoints the dashboard and the service answer
UI_ENDPOINT_KEYS = {
    "/api/serving": {"compile_cache", "draining", "models"},
    "/api/slo": {"breaches_total", "burn", "objectives", "recent_breaches", "samples",
                 "thresholds", "windows"},
    "/api/history?range_s=60": {"agg", "annotations", "end", "now", "series", "source",
                                "start", "step"},
    "/api/resilience": {"sites"},
    "/api/online": {"trainers"},
    "/api/memory": {"compile_cache", "devices", "executables", "report"},
    "/api/telemetry": {"metrics", "system"},
    "/api/flightrecorder": {"capacity", "dropped", "dumps", "events", "recorded"},
}
# rows 10-12 at this path's shapes: (shape name, the main row of that shape)
SLICE23_ROWS = {"softmax_xent_fwd": ("N=64 C=10", "softmax_xent_fwd@lenet"),
                "softmax_xent_bwd": ("N=64 C=10", "softmax_xent_bwd@lenet"),
                "adam_update": ("8 leaves", "adam_update@lenet")}
# the analyzer's row labels of rows 10-12 (scripts/torch_analyze_trace.py)
UI_TRACE_ROWS = {"softmax_xent_fwd": "softmax_xent fwd, row 10",
                 "softmax_xent_bwd": "softmax_xent bwd, row 11",
                 "adam_update": "adam, row 12"}


def ui_write_idx(path: str, arr) -> None:
    """``arr`` (uint8) as an IDX file."""
    import struct

    with open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 0x08, arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.tobytes())


def ui_mnist_files(root: str, seed: int) -> None:
    """The four MNIST IDX files of UI_SPLITS' sizes under ``root``: each
    image one of 10 class patterns (a quarter of the pixels at 160) plus
    uniform noise 0-95, labels uniform."""
    import numpy as np

    rng = np.random.default_rng(seed)
    protos = np.where(rng.random((10, 28, 28)) < 0.25, 160, 0).astype(np.uint8)
    for split, n in UI_SPLITS.items():
        labels = rng.integers(0, 10, n).astype(np.uint8)
        images = protos[labels] + rng.integers(0, 96, (n, 28, 28), dtype=np.uint8)
        ui_write_idx(os.path.join(root, f"{split}-images-idx3-ubyte"), images)
        ui_write_idx(os.path.join(root, f"{split}-labels-idx1-ubyte"), labels)


def loader_readings(epochs, n: int) -> dict:
    """The row ids of a loader's epochs (a list of epochs, each a list of
    batches of ids): every epoch's rows distinct and in [0, n), every epoch
    full (drop_last: n // B batches), and each epoch in another order than
    the one before."""
    import numpy as np

    ids = [np.concatenate(e).astype(np.int64) for e in epochs]
    return {
        "rows_distinct": all(len(np.unique(e)) == len(e) for e in ids),
        "rows_in_range": all(int(e.min()) >= 0 and int(e.max()) < n for e in ids),
        "epochs_full": all(len(e) == len(ids[0]) for e in ids),
        "reshuffled": all(not np.array_equal(a, b) for a, b in zip(ids, ids[1:])),
    }


def loader_ok(r: dict) -> bool:
    return all(r.values())


def loader_fault(epochs, fault: str):
    """A wrong loader's epochs: batch 0 served again in place of batch 1,
    or the second epoch in the first one's order."""
    if fault == "loader_repeats_a_batch":
        return [[e[0], e[0], *e[2:]] for e in epochs]
    return [epochs[0], list(epochs[0])]


def meanmag_readings(record: dict, host_params) -> dict:
    """A StatsListener record's param mean magnitudes against mean |w| of
    the net's params recomputed here: the largest relative difference, and
    the names on each side."""
    import numpy as np

    want = {f"{i}_{k}": float(np.mean(np.abs(v)))
            for i, layer in enumerate(host_params) for k, v in layer.items()}
    got = record["param_mean_magnitudes"]
    return {"names_equal": sorted(got) == sorted(want),
            "max_rel": max(abs(got[k] - w) / w for k, w in want.items()) if
            sorted(got) == sorted(want) else float("inf")}


class FlippedGainsTsne:
    """A wrong exact t-SNE: its gains grow where the gradient's sign agrees
    with the velocity's (the rule's comparison flipped)."""

    @staticmethod
    def make(**kw):
        import torch

        from deeplearning4j_tpu_torch.plot import Tsne

        class Flipped(Tsne):
            def _step(self, y, vel, gains, p, momentum):
                d2 = ((y[:, None, :] - y[None]) ** 2).sum(-1)
                num = 1.0 / (1.0 + d2)
                num.fill_diagonal_(0.0)
                q = (num / num.sum()).clamp_min(1e-12)
                pq = (p - q) * num
                grad = 4.0 * (torch.diag(pq.sum(1)) - pq) @ y
                gains = torch.where(torch.sign(grad) == torch.sign(vel), gains + 0.2,
                                    gains * 0.8).clamp_min(0.01)
                vel = momentum * vel - self.learning_rate * gains * grad
                y = y + vel
                return y - y.mean(0), vel, gains

        return Flipped(**kw)


def knn_agreement(points, labels, k: int = UI_KNN) -> float:
    """The share of each point's k nearest neighbours (Euclidean, itself
    left out) that carry its label."""
    import numpy as np

    p = np.asarray(points, np.float64)
    sq = (p * p).sum(1)
    d = sq[:, None] + sq[None] - 2.0 * p @ p.T
    np.fill_diagonal(d, np.inf)
    nn = np.argpartition(d, k, axis=1)[:, :k]
    return float((labels[nn] == labels[:, None]).mean())


def http_json(base: str, path: str, payload=None):
    """(status, JSON body) of a GET, or of a POST of ``payload``."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data, {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            body = r.read()
            status = r.status
    except urllib.error.HTTPError as e:
        body, status = e.read(), e.code
    try:
        return status, json.loads(body or b"null")
    except json.JSONDecodeError:
        return status, body.decode()


def median_host_ms(fn, reps: int = 11) -> float:
    """Median host ms of ``reps`` calls of ``fn``."""
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        runs.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(runs)


def ui_update_ms(torch, net, batches, listeners) -> float:
    """ms per update over ``batches`` (one fit each, host clock, synchronized
    at the end) with ``listeners`` attached, after 2 warm-up updates."""
    net.set_listeners(*listeners)
    for b in batches[:2]:
        net.fit(b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        net.fit(b)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    net.set_listeners()
    return ms


def phase_ui_lenet(torch, card):
    """Slice 23's path (see UI_*). Returns (launch counts of the training
    run, readings)."""
    import importlib.util
    import tempfile
    import threading

    import numpy as np

    from deeplearning4j_tpu_torch import (MultiLayerNetwork, NumpyDataSetIterator,
                                          lenet_mnist_conf, load_jax_params, ops,
                                          params_to_numpy)
    from deeplearning4j_tpu_torch.clustering import KMeansClustering
    from deeplearning4j_tpu_torch.datasets.fetchers import load_mnist, read_idx
    from deeplearning4j_tpu_torch.plot import Tsne
    from deeplearning4j_tpu_torch.profiler import ProfilingListener
    from deeplearning4j_tpu_torch.runtime import native_loader
    from deeplearning4j_tpu_torch.serving import InferenceService, set_service
    from deeplearning4j_tpu_torch.ui import (ConvolutionalIterationListener, InMemoryStatsStorage,
                                             SqliteStatsStorage, StatsListener, UIServer,
                                             post_tsne)
    from deeplearning4j_tpu_torch.ui import stats_listener as stats_mod

    spec = importlib.util.spec_from_file_location(
        "torch_analyze_trace", os.path.join(HERE, "scripts", "torch_analyze_trace.py"))
    analyzer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(analyzer)

    t_phase = time.perf_counter()
    readings, times, faults = {}, {}, {}
    # threads that earlier phases left running (any of them that launches a
    # kernel would show in this phase's launch counts and trace)
    readings["threads_at_start"] = sorted(t.name for t in threading.enumerate()
                                          if t is not threading.main_thread())
    tmp = tempfile.TemporaryDirectory(prefix="ui_lenet_")
    root = tmp.name
    try:
        # ---- 1. data: the IDX files, read natively and in Python
        t0 = time.perf_counter()
        available = native_loader.native_available()  # builds the library
        times["native_build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ui_mnist_files(root, SEED + 23)
        times["idx_write_s"] = time.perf_counter() - t0
        img_path = os.path.join(root, "train-images-idx3-ubyte")
        t0 = time.perf_counter()
        native = native_loader.native_idx_read(img_path)
        times["native_idx_read_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        python = read_idx(img_path)
        times["python_idx_read_s"] = time.perf_counter() - t0
        readings["idx_bit_for_bit"] = bool(
            available and native.dtype == np.float32 and native.shape == (60000, 28, 28)
            and np.array_equal(native, python.astype(np.float32))
            and np.array_equal(native_loader.native_idx_read(
                os.path.join(root, "train-labels-idx1-ubyte")),
                read_idx(os.path.join(root, "train-labels-idx1-ubyte")).astype(np.float32)))
        readings["idx_bytes"] = os.path.getsize(img_path)
        del native, python
        x, y = load_mnist(train=True, root=root)  # through native_idx_read
        tx, ty = load_mnist(train=False, root=root)
        x, tx = x.reshape(-1, 28, 28, 1), tx.reshape(-1, 28, 28, 1)
        yh = np.eye(10, dtype=np.float32)[y]

        # ---- 2. the loader: ids over two epochs (and its wrong versions),
        # a full epoch of images against NumpyDataSetIterator
        ids = np.arange(len(x), dtype=np.float32)[:, None]
        id_it = native_loader.NativeDataSetIterator(ids, ids, UI_B, shuffle=True, seed=SEED,
                                                   queue_size=4, workers=2)
        epochs = [[ds.features[:, 0].copy() for ds in id_it] for _ in range(2)]
        id_it.close()
        readings["loader"] = loader_readings(epochs, len(x))
        for fault in UI_FAULTS[:2]:
            r = loader_readings(loader_fault(epochs, fault), len(x))
            faults[fault] = dict(r, caught=not loader_ok(r))
        img_it = native_loader.NativeDataSetIterator(x, yh, UI_B, shuffle=True, seed=SEED,
                                                    queue_size=4, workers=2)
        order = native_loader.native_shuffled_indices(len(x), SEED)
        first = next(iter(img_it))
        readings["loader_gathers_rows"] = bool(
            np.array_equal(first.features, x[order[:UI_B]])
            and np.array_equal(first.labels, yh[order[:UI_B]]))
        img_it.reset()
        for name, it in (("native", img_it),
                         ("numpy", NumpyDataSetIterator(x, yh, UI_B, shuffle=True, seed=SEED))):
            t0 = time.perf_counter()
            n = sum(1 for _ in it)
            times[f"{name}_batches_per_s"] = n / (time.perf_counter() - t0)
        img_it.close()

        # ---- 3. training under the listeners, counts from 0; the CPU
        # port over the same batches
        conf = lenet_mnist_conf()
        host = conf_host(conf)
        rows = UI_B * UI_UPDATES
        net = load_jax_params(MultiLayerNetwork(conf), host)
        db = os.path.join(root, "stats.db")
        storage = SqliteStatsStorage(db)
        rec = LossRecorder()
        prof = ProfilingListener(os.path.join(root, "trace"), **UI_PROFILE)
        net.set_listeners(StatsListener(storage, session_id="ui_lenet"),
                          ConvolutionalIterationListener(storage, frequency=UI_CONV_EVERY,
                                                         session_id="ui_lenet"),
                          prof, rec)
        train_it = native_loader.NativeDataSetIterator(x[:rows], yh[:rows], UI_B, shuffle=True,
                                                      seed=SEED, queue_size=4, workers=2)
        torch.cuda.synchronize()
        ops.reset_counters()
        t0 = time.perf_counter()
        net.fit(train_it)
        torch.cuda.synchronize()
        times["train_epoch_s"] = time.perf_counter() - t0
        launches = ops.counters()
        net.set_listeners()
        train_it.close()
        card_losses = np.array([float(v) for v in rec.losses])
        cpu = load_jax_params(MultiLayerNetwork(conf, device="cpu"), host)
        cpu_rec = LossRecorder()
        cpu.set_listeners(cpu_rec)
        cpu_it = native_loader.NativeDataSetIterator(x[:rows], yh[:rows], UI_B, shuffle=True,
                                                    seed=SEED, queue_size=4, workers=2)
        cpu_it.reset()  # fit's epoch: the loader's first reset
        for ds, _ in zip(cpu_it, range(UI_COMPARED)):
            cpu.fit(ds)
        cpu_it.close()
        cpu_losses = np.array([float(v) for v in cpu_rec.losses])
        readings["loss_rel"] = float(np.max(np.abs(card_losses[:UI_COMPARED] - cpu_losses)
                                            / np.abs(cpu_losses)))
        readings["losses"] = {"card": card_losses.tolist(), "cpu": cpu_losses.tolist()}
        expected = dict.fromkeys(launches, 0)
        expected.update({"softmax_xent_fwd": UI_UPDATES, "softmax_xent_bwd": UI_UPDATES,
                         "adam_update": UI_UPDATES * adam_launches(net)})
        readings["launches_as_expected"] = launches == expected
        readings["launches_unexpected"] = {k: [launches.get(k, 0), n] for k, n in expected.items()
                                           if launches.get(k, 0) != n}

        # ---- 4. the trace of the listener's window
        report = analyzer.analyze(prof.trace_path)
        traced = {k: report["kernel_launches"][label] for k, label in UI_TRACE_ROWS.items()}
        readings["trace"] = {"source": report["source"], "launches": traced,
                             "total_device_ms": report["total_device_ns"] / 1e6,
                             "buckets_pct": report["buckets_pct"],
                             "top_ops": [dict(o, name=o["name"][:80])
                                         for o in report["top_ops"][:8]]}
        readings["trace_once_per_update"] = (report["source"] == "device" and all(
            n == UI_PROFILE["duration"] for n in traced.values()))

        # ---- 5. the dashboard over the SQLite file the listener wrote
        server = UIServer(port=0)
        served_storage = SqliteStatsStorage(db)
        server.attach(served_storage)
        base = f"http://127.0.0.1:{server.port}"
        svc = None
        try:
            pages = {p: http_json(base, p)[0] for p in (
                "/train", "/train/model", "/train/system", "/train/flow",
                "/train/activations", "/train/tsne", "/train/history")}
            _, overview = http_json(base, "/train")
            _, sessions = http_json(base, "/api/sessions")
            _, ups = http_json(base, "/api/updates?session=ui_lenet")
            _, mm = http_json(base, "/api/meanmag?session=ui_lenet")
            _, hist = http_json(base, f"/api/histograms?session=ui_lenet&iteration={UI_UPDATES}")
            _, static = http_json(base, "/api/static?session=ui_lenet")
            _, acts = http_json(base, "/api/activations?session=ui_lenet")
            _, system = http_json(base, "/api/system?session=ui_lenet")
            host_now = params_to_numpy(net)
            stats_ups = [u for u in storage.get_all_updates("ui_lenet") if "score" in u
                         and "param_mean_magnitudes" in u]
            numel = {f"{i}_{k}": v.size for i, layer in enumerate(host_now)
                     for k, v in layer.items()}
            dash = meanmag_readings(stats_ups[-1], host_now)
            dash.update(
                pages_ok=all(s == 200 for s in pages.values()) and "Training overview" in overview,
                sessions=sessions, updates=len(ups),
                iterations_ok=[u["iteration"] for u in stats_ups] == list(range(1, UI_UPDATES + 1)),
                meanmag_series_ok=[v for v in mm["param"]["0_W"] if v is not None] == [
                    u["param_mean_magnitudes"]["0_W"] for u in stats_ups],
                histogram_counts_ok=hist["iteration"] == UI_UPDATES
                and sorted(hist["param_histograms"]) == sorted(numel) and all(
                    sum(h["counts"]) == numel[k] and len(h["bins"]) == 21
                    for kind in ("param", "gradient", "update")
                    for k, h in hist[f"{kind}_histograms"].items()),
                histogram_names=sorted(hist["param_histograms"]),
                scores_ok=[u["score"] for u in stats_ups] == card_losses.tolist(),
                static_ok=static[0]["num_params"] == 431080
                and static[0]["model_class"] == "MultiLayerNetwork",
                activations_ok=acts.get("conv_activations", {}).get("layer") == 0
                and len(acts["conv_activations"]["maps"]) == 16
                and acts["iteration"] == UI_UPDATES - UI_UPDATES % UI_CONV_EVERY,
                system_names_card=any(
                    r.get("device_memory") and r["device_memory"][0].get("device_kind")
                    == torch.cuda.get_device_name(0) for r in system),
                system_rows=len(system))
            readings["dashboard"] = dash
            # the wrong listener: mean magnitudes without the abs
            real = stats_mod._mean_magnitude
            stats_mod._mean_magnitude = lambda a: float(np.mean(np.asarray(a)))
            try:
                wrong_store = InMemoryStatsStorage()
                StatsListener(wrong_store, session_id="wrong").iteration_done(
                    net, net.iteration, net._last_loss)
            finally:
                stats_mod._mean_magnitude = real
            r = meanmag_readings(wrong_store.get_latest_update("wrong"), host_now)
            faults["mean_magnitude_without_abs"] = dict(r, caught=r["max_rel"] > 0)

            # ---- 6. what the listener costs an update
            batches = [(x[i:i + UI_B], yh[i:i + UI_B])
                       for i in range(rows, rows + UI_B * UI_TIMED, UI_B)]
            ms = {}
            for turn, (name, freq) in enumerate((("none", None), ("every_1", 1),
                                                 ("every_10", 10), ("every_10", 10),
                                                 ("every_1", 1), ("none", None))):
                lst = [] if freq is None else [StatsListener(storage, frequency=freq,
                                                             session_id=f"timed_{turn}")]
                ms.setdefault(name, []).append(ui_update_ms(torch, net, batches, lst))
            times["ms_per_update"] = ms

            # ---- 7. serving over HTTP on the default, replayed path
            svc = InferenceService()
            set_service(svc)
            svc.register("lenet", net)
            svc.register("lenet_at_init", load_jax_params(MultiLayerNetwork(conf), host))
            t0 = time.perf_counter()
            buckets = svc.warmup("lenet", tx[:1])  # every row bucket captured ahead
            times["service_warmup"] = {"buckets": buckets, "seconds": time.perf_counter() - t0}
            held = tx[:UI_B]
            want = net.output(held)
            _, got = http_json(base, "/serving/predict",
                               {"model": "lenet", "features": held.tolist()})
            _, other = http_json(base, "/serving/predict",
                                 {"model": "lenet_at_init", "features": held.tolist()})
            _, cls = http_json(base, "/serving/predict",
                               {"model": "lenet", "features": held.tolist(), "argmax": True})
            served = {"rel": rel_err(got["output"], want),
                      "argmax_equal": cls["classes"] == want.argmax(-1).tolist(),
                      "accuracy": float((want.argmax(-1) == ty[:UI_B]).mean())}
            r = {"rel": rel_err(other["output"], want)}
            faults["served_by_another_model"] = dict(r, caught=r["rel"] > UI_LIMITS["served_rel"])
            codes = {}
            for path, keys in UI_ENDPOINT_KEYS.items():
                code, body = http_json(base, path)
                codes[path] = {"status": code, "keys_ok": isinstance(body, dict)
                               and keys <= set(body)}
            code, metrics = http_json(base, "/metrics")
            codes["/metrics"] = {"status": code, "keys_ok": "dl4jtpu_serve_requests_total"
                                 in str(metrics)}
            for path in ("/api/fleet", "/api/ircost"):
                code, body = http_json(base, path)
                codes[path] = {"status": code, "keys_ok": "error" in body}
            served["endpoints"] = codes
            served["endpoints_ok"] = all(
                c["keys_ok"] and c["status"] == (501 if p in ("/api/fleet", "/api/ircost")
                                                 else 200) for p, c in codes.items())
            errors = []

            def client(i):
                rng = np.random.default_rng(SEED + 230 + i)
                for _ in range(UI_HTTP["requests"]):
                    start = int(rng.integers(0, len(tx) - UI_HTTP["rows"]))
                    code, _ = http_json(base, "/serving/predict", {
                        "model": "lenet",
                        "features": tx[start:start + UI_HTTP["rows"]].tolist()})
                    if code != 200:
                        errors.append(code)

            alone = []
            for i in range(UI_HTTP["requests"]):  # one client: each request's ms
                t0 = time.perf_counter()
                http_json(base, "/serving/predict", {
                    "model": "lenet", "features": tx[8 * i:8 * i + UI_HTTP["rows"]].tolist()})
                alone.append((time.perf_counter() - t0) * 1e3)
            body = {"model": "lenet", "features": tx[:UI_HTTP["rows"]].tolist()}
            text = json.dumps(body)
            times["http_request_ms_one_client"] = {
                "median": statistics.median(alone), "max": max(alone),
                # a request's JSON on the host: the client's encode (with
                # tolist), the server's parse
                "json_encode_ms": median_host_ms(
                    lambda: json.dumps({"model": "lenet",
                                        "features": tx[:UI_HTTP["rows"]].tolist()})),
                "json_parse_ms": median_host_ms(
                    lambda: np.asarray(json.loads(text)["features"]))}
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(UI_HTTP["clients"])]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            wall = time.perf_counter() - t0
            n_req = UI_HTTP["clients"] * UI_HTTP["requests"]
            times["http_requests_per_s"] = n_req / wall
            served["http_errors"] = errors
            served["threads_done"] = not any(t.is_alive() for t in threads)
            readings["served"] = served

            # ---- 8. t-SNE and k-means of the penultimate features
            feats = np.concatenate([net.feed_forward(tx[i:i + 500])[4]
                                    for i in range(0, UI_TSNE_N, 500)])
            labels = ty[:UI_TSNE_N]
            kw = dict(max_iter=UI_TSNE_COMPARED, seed=SEED)
            first_card = Tsne(**kw).fit_transform(feats)
            first_cpu = Tsne(device="cpu", **kw).fit_transform(feats)
            scale = float(np.abs(first_cpu).max())
            tsne = {"first_rel": float(np.abs(first_card - first_cpu).max()) / scale}
            wrong = FlippedGainsTsne.make(**kw).fit_transform(feats)
            r = {"first_rel": float(np.abs(wrong - first_cpu).max()) / scale}
            faults["tsne_gains_sign_flipped"] = dict(r, caught=r["first_rel"] > UI_LIMITS["tsne_rel"])
            full = Tsne(seed=SEED)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            full._joint_p(torch.as_tensor(feats, dtype=torch.float64, device=DEVICE))
            torch.cuda.synchronize()
            joint_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            emb = full.fit_transform(feats)
            tsne_s = time.perf_counter() - t0
            times["tsne"] = {"n": UI_TSNE_N, "iterations": full.max_iter, "seconds": tsne_s,
                             "affinities_s": joint_s,
                             "ms_per_iteration": (tsne_s - joint_s) * 1e3 / full.max_iter}
            tsne.update(finite=bool(np.isfinite(emb).all()), shape=list(emb.shape),
                        knn_agreement=knn_agreement(emb, labels),
                        feature_knn_agreement=knn_agreement(feats, labels))
            post_tsne(storage, "ui_lenet", emb, labels)
            _, back = http_json(base, "/api/tsne?session=ui_lenet")
            tsne["dashboard_round_trip"] = (
                back["coords"] == np.round(emb[:, :2].astype(np.float64), 4).tolist()
                                            and back["labels"] == [str(v) for v in labels])
            readings["tsne"] = tsne
            km_card = KMeansClustering(k=UI_KMEANS_K, seed=SEED)
            t0 = time.perf_counter()
            km_card._init_centers(feats)  # kmeans++ on the host, timed apart
            init_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            km_card.fit(feats)
            km_s = time.perf_counter() - t0
            # the CPU's own run stops where its f32 inertia stops moving by
            # tol, which the two devices' sums of 2,500 distances in
            # different orders can cross an iteration apart; so the card is
            # held against the CPU's run of the same number of iterations,
            # and a tie is read with the centers that made that iteration's
            # assignment (the CPU's after one iteration fewer)
            n_card = km_card.n_iter_
            km_own = KMeansClustering(k=UI_KMEANS_K, seed=SEED, device="cpu").fit(feats)
            km_cpu = KMeansClustering(k=UI_KMEANS_K, seed=SEED, device="cpu", tol=0.0,
                                      max_iterations=n_card).fit(feats)
            assigning = (KMeansClustering(k=UI_KMEANS_K, seed=SEED, device="cpu", tol=0.0,
                                          max_iterations=n_card - 1).fit(feats).cluster_centers_
                         if n_card > 1 else km_cpu._init_centers(feats.astype(np.float32)))
            diff = np.nonzero(km_card.labels_ != km_cpu.labels_)[0]
            f64 = feats.astype(np.float64)
            c = assigning.astype(np.float64)
            d = ((f64[diff, None, :] - c[None]) ** 2).sum(-1)
            gap = np.abs(d[np.arange(len(diff)), km_card.labels_[diff]]
                         - d[np.arange(len(diff)), km_cpu.labels_[diff]])
            # a tie: within f32's rounding of the expanded distance
            scale = (f64[diff] ** 2).sum(1) + (c ** 2).sum(1).max()
            readings["kmeans"] = {
                "iterations": [n_card, km_own.n_iter_],
                "cpu_iterations_compared": km_cpu.n_iter_,
                "assignments_differ": int(len(diff)),
                "differ_not_at_ties": int((gap > KMEANS_TIE * scale).sum()),
                "inertia_rel": abs(km_card.inertia_ - km_cpu.inertia_) / km_cpu.inertia_,
                "cluster_label_purity": float(sum(
                    np.bincount(labels[km_card.labels_ == j], minlength=10).max()
                    for j in range(UI_KMEANS_K) if (km_card.labels_ == j).any()) / len(labels))}
            times["kmeans"] = {"n": UI_TSNE_N, "k": UI_KMEANS_K, "iterations": km_card.n_iter_,
                               "seconds": km_s, "kmeans_pp_s": init_s,
                               "ms_per_iteration": (km_s - init_s) * 1e3 / km_card.n_iter_}
        finally:
            server.stop()
            served_storage.close()
            if svc is not None:
                svc.stop()
                set_service(None)
    finally:
        tmp.cleanup()
    times["phase_s"] = time.perf_counter() - t_phase
    km, ts, sv, dash = (readings["kmeans"], readings["tsne"], readings["served"],
                        readings["dashboard"])
    checks = {
        "idx_bit_for_bit": readings["idx_bit_for_bit"], "loader": loader_ok(readings["loader"]),
        "loader_gathers_rows": readings["loader_gathers_rows"],
        "loss_rel": readings["loss_rel"] <= UI_LIMITS["loss_rel"],
        "loss_falls": bool(card_losses[-1] < card_losses[0]),
        "updates": len(card_losses) == UI_UPDATES,
        "launches_as_expected": readings["launches_as_expected"],
        "trace_once_per_update": readings["trace_once_per_update"],
        "meanmag_names_equal": dash["names_equal"], "meanmag_equal": dash["max_rel"] == 0.0,
        **{f"dashboard_{k}": dash[k] for k in (
            "pages_ok", "iterations_ok", "meanmag_series_ok", "histogram_counts_ok",
            "scores_ok", "static_ok", "activations_ok", "system_names_card")},
        "served_rel": sv["rel"] <= UI_LIMITS["served_rel"],
        "served_argmax_equal": sv["argmax_equal"], "endpoints_ok": sv["endpoints_ok"],
        "no_http_error": not sv["http_errors"], "threads_done": sv["threads_done"],
        "tsne_first_rel": ts["first_rel"] <= UI_LIMITS["tsne_rel"], "tsne_finite": ts["finite"],
        "tsne_knn_agreement": ts["knn_agreement"] >= UI_LIMITS["tsne_knn_agreement"],
        "tsne_dashboard_round_trip": ts["dashboard_round_trip"],
        "kmeans_differ_only_at_ties": km["differ_not_at_ties"] == 0,
        "kmeans_inertia_rel": km["inertia_rel"] <= UI_LIMITS["kmeans_inertia_rel"],
        "faults_caught": all(f["caught"] for f in faults.values())
        and set(faults) == set(UI_FAULTS)}
    ok = all(checks.values())
    emit("ui_lenet", B=UI_B, updates=UI_UPDATES, limits=UI_LIMITS, readings=readings,
         faults=faults, kernel_launches=launches, times=times, checks=checks, ok=ok, gpu=card)
    if not ok:
        raise AssertionError("the training UI path failed its checks: "
                             f"{[k for k, v in checks.items() if not v]}")
    return launches, {"times": times, "readings": {k: readings[k] for k in (
        "loss_rel", "tsne", "kmeans")}, "served_rel": sv["rel"], "trace": readings["trace"]}


# ---- slice 24: the NLP stack and graph embeddings. Every corpus and graph
# is drawn from the seed. Word2Vec at GoogleNews' width (300, DL4J's
# sentiment example's vectorSize) on 25,000 sentences of 20 tokens: 14 words
# drawn Zipf(1.0) over text8's 71,290 types at min count 5, three words of
# one of 40 planted topics (10 words each) and three of one of two planted
# polarities (10 words each), in a shuffled order. Skip-gram with HS and 5
# negatives, window 5, min count 5, batch 512 (the JAX defaults).
NLP_SENTENCES, NLP_LEN, NLP_TYPES = 25000, 20, 71290
NLP_TOPICS, NLP_POLARITIES, NLP_GROUP_WORDS, NLP_PLANTED = 40, 2, 10, 3
W2V = dict(layer_size=300, window=5, min_word_frequency=5, use_hs=True, negative=5,
           batch_size=512)
W2V_CPU_SENTENCES = 1000  # the head fit on the card and on the CPU
# the tables after the head fit, card against CPU: max |err| over the
# table's largest element. The CPU sums a row's contributions in their
# order, the card after a sort of the row ids (index_put_ with accumulate);
# the phase also reads two card runs against each other. The CPU's sums in
# the reverse order part from its usual ones by up to 2.5e-5 (syn1; SGD
# carries an ulp's change on through the fit; scripts/nlp_cpu_pins.py); the
# wrong versions read 0.024 and more on the CPU
W2V_TABLE_REL = 5e-4
W2V_FAULTS = ("syn1_from_updated_syn0", "neg_without_target_skip", "hs_code_sign_flipped")
W2V_RECALL_PIN = 0.2  # the CPU run reads 0.264 (scripts/nlp_cpu_pins.py)
W2V_NEAREST = 10
W2V_TEXT_ATOL = 5e-7  # the C text format's 6 decimals (and half an f32 step of the parse)
W2V_PROFILED_SENTENCES = 500
# ParagraphVectors: 2,000 labelled documents of 50 tokens over 20 labels
# (label l: 10 of topic l's words among 40 Zipf words), 200 held out
PV_DOCS, PV_HELD, PV_LEN, PV_LABELS, PV_PLANTED = 2000, 200, 50, 20, 10
PV = dict(layer_size=300, window=5)
# infer_vector, card against CPU on the same tables: the card read 3.8e-7
# (DBOW) and 1.9e-5 (DM); the CPU's f32 against the same 30 steps in
# float64 reads 2.6e-7 and 3.7e-6 (the phase reads it too)
PV_INFER_REL = 1e-4
PV_INFER_COMPARED = 8
# held-out predict accuracy; the CPU run reads 0.995 and 0.110 (chance 0.05):
# infer_vector fits a doc vector alone against the words (DBOW's way) for
# both, so DM's labels, trained beside their context, are predicted worse
PV_PIN = {"dbow": 0.9, "dm": 0.07}
# GloVe at the JAX defaults on the corpus's first 100,000 tokens; card
# against CPU over 2 epochs on its first 20,000
GLOVE = dict(layer_size=100, window=15, x_max=100.0, alpha=0.75, batch_size=4096, epochs=25)
GLOVE_SENTENCES, GLOVE_CPU_SENTENCES, GLOVE_CPU_EPOCHS = 5000, 1000, 2
GLOVE_REL = 1e-5  # the CPU's reversed sums read 2.2e-7 (scripts/nlp_cpu_pins.py)
GLOVE_RECALL_PIN = 0.12  # the CPU run reads 0.165
DIST_WORKERS, DIST_SENTENCES = 4, 4000
# DeepWalk at BlogCatalog's size (Perozzi et al. 2014: 10,312 vertices, 39
# groups, 333,983 edges) as a stochastic block model, 80% of the edges
# inside a group; Perozzi's d=128, w=10, t=40, and 1 walk a vertex (not 80:
# 2 took 45-54 s of the phase on the card, host-bound)
DW_VERTICES, DW_GROUPS, DW_EDGES, DW_INSIDE = 10312, 39, 334000, 0.8
DW = dict(vector_size=128, window=10, walk_length=40, walks_per_vertex=1)
DW_CPU_WALKS = 200
DW_REL = 2e-5  # the CPU's reversed sums read 6.8e-7 (scripts/nlp_cpu_pins.py)
DW_RECALL_SAMPLE = 1000
DW_RECALL_PIN = 0.7  # the CPU run reads 0.793 (1.0 at 2 walks a vertex)
# DL4J's Word2VecSentimentRNN: the 300-d vectors through
# Word2VecDataSetIterator (max_length 256, B=64) into GravesLSTM(300 -> 256,
# tanh) and RnnOutputLayer(softmax, MCXENT, 2 classes); Adam at 2e-2, l2
# 1e-5, Xavier, ClipElementWiseAbsoluteValue at 1.0. Reviews of 64-256
# tokens (Zipf words, one in SENT_DENSITY a word of the review's polarity)
SENT_TRAIN, SENT_HELD, SENT_LENGTHS, SENT_DENSITY = 1024, 256, (64, 256), 10
SENT_B, SENT_T, SENT_H, SENT_LR, SENT_L2 = 64, 256, 256, 2e-2, 1e-5
SENT_EPOCHS = 3
SENT_CPU = dict(reviews=128, lengths=(16, 48), max_length=48)  # 2 updates, card against CPU
SENT_PIN = 0.9  # held-out accuracy; the CPU run reads 0.992
# the card against the CPU over the first 2 updates: RECIPE_LIMITS, but the
# largest param difference at the same share of Adam's lr as the recipe's
# (2e-4 at 1e-3): an element whose gradient's sign is uncertain steps about
# lr either way. The card read 2.9e-4 (lr/69) and no element over lr/10
SENT_LIMITS = dict(RECIPE_LIMITS["float32"],
                   max_param_abs=RECIPE_LIMITS["float32"]["max_param_abs"] * SENT_LR / RECIPE_LR)
SLICE24_ROWS = ("lstm_seq_masked_train_fwd", "lstm_seq_masked_bwd", "drw_product",
                "softmax_xent_fwd", "softmax_xent_bwd", "adam_update")


def nlp_zipf(rng, shape):
    """Word ids drawn Zipf(1.0) over NLP_TYPES types."""
    import numpy as np

    p = 1.0 / np.arange(1, NLP_TYPES + 1)
    return rng.choice(NLP_TYPES, size=shape, p=p / p.sum())


def nlp_corpus(seed):
    """{"sentences": token lists, "topic": [n], "polarity": [n]}: NLP_SENTENCES
    sentences of NLP_LEN tokens, each 3 words of its topic ("t{k}_{j}"), 3 of
    its polarity ("p{k}_{j}") and Zipf words ("w{k}"), shuffled."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n, zipf = NLP_SENTENCES, NLP_LEN - 2 * NLP_PLANTED
    z = nlp_zipf(rng, (n, zipf))
    topic = rng.integers(0, NLP_TOPICS, n)
    polarity = rng.integers(0, NLP_POLARITIES, n)
    tw = rng.integers(0, NLP_GROUP_WORDS, (n, NLP_PLANTED))
    pw = rng.integers(0, NLP_GROUP_WORDS, (n, NLP_PLANTED))
    order = np.argsort(rng.random((n, NLP_LEN)), axis=1)
    sentences = []
    for i in range(n):
        toks = ([f"w{k}" for k in z[i]] + [f"t{topic[i]}_{j}" for j in tw[i]]
                + [f"p{polarity[i]}_{j}" for j in pw[i]])
        sentences.append([toks[k] for k in order[i]])
    return {"sentences": sentences, "topic": topic, "polarity": polarity}


def topic_words(k: int):
    return [f"t{k}_{j}" for j in range(NLP_GROUP_WORDS)]


def topic_recall(lookup, topics: int = NLP_TOPICS, top_n: int = W2V_NEAREST) -> float:
    """The mean share of a planted topic word's ``top_n`` nearest words
    (cosine over syn0) that are words of its topic, over every topic word in
    the vocabulary (at most 9 of 10 can be)."""
    shares = []
    for k in range(topics):
        group = set(topic_words(k))
        for w in group:
            if lookup.vocab.contains_word(w):
                near = lookup.words_nearest(w, top_n)
                shares.append(sum(x in group for x in near) / len(near))
    return sum(shares) / len(shares)


def table_rel(got, want) -> dict:
    """max |got - want| over want's largest element, each table."""
    import numpy as np

    out = {}
    for name in ("syn0", "syn1", "syn1neg"):
        a, b = getattr(got.lookup, name, None), getattr(want.lookup, name, None)
        if b is not None:
            out[name] = float(np.abs(a - b).max() / np.abs(b).max())
    return out


def w2v_fault(sv, fault):
    """Install one of W2V_FAULTS in the port's SequenceVectors steps;
    returns what undoes it."""
    import torch

    real = {"hs_step": sv.hs_step, "neg_step": sv.neg_step}

    def hs_wrong(syn0, syn1, bufs, src, src_mask, points, codes, code_mask, lr):
        h, denom = sv._source_mean(syn0, src, src_mask)
        node = sv.rows_of(syn1, points)
        u = torch.bmm(node, h[:, :, None])[..., 0]
        sign = (2.0 * codes - 1.0) if fault == "hs_code_sign_flipped" else 1.0 - 2.0 * codes
        g = -sign * torch.sigmoid(-sign * u) * code_mask
        grad_h = torch.bmm(g[:, None, :], node)[:, 0]
        i0, d0 = sv._syn0_rows(grad_h, denom, src, src_mask)
        if fault == "syn1_from_updated_syn0":
            sv.apply_rows(syn0, bufs[0], i0, d0, lr)
            h, _ = sv._source_mean(syn0, src, src_mask)
        d1 = (g[..., None] * h[:, None, :]).reshape(-1, h.shape[-1])
        sv.apply_rows(syn1, bufs[1], points.reshape(-1), d1, lr)
        if fault != "syn1_from_updated_syn0":
            sv.apply_rows(syn0, bufs[0], i0, d0, lr)

    def neg_unskipped(syn0, syn1neg, bufs, src, src_mask, tgt, negs, lr):
        h, denom = sv._source_mean(syn0, src, src_mask)
        pos_vec, neg_vec = sv.rows_of(syn1neg, tgt), sv.rows_of(syn1neg, negs)
        g_pos = -torch.sigmoid(-(h * pos_vec).sum(-1))
        g_neg = torch.sigmoid(torch.bmm(neg_vec, h[:, :, None])[..., 0])  # no skip
        grad_h = g_pos[:, None] * pos_vec + torch.bmm(g_neg[:, None, :], neg_vec)[:, 0]
        D = h.shape[-1]
        d1 = torch.cat([g_pos[:, None] * h, (g_neg[..., None] * h[:, None, :]).reshape(-1, D)])
        i0, d0 = sv._syn0_rows(grad_h, denom, src, src_mask)
        sv.apply_rows(syn1neg, bufs[1], torch.cat([tgt, negs.reshape(-1)]), d1, lr)
        sv.apply_rows(syn0, bufs[0], i0, d0, lr)

    if fault == "neg_without_target_skip":
        sv.neg_step = neg_unskipped
    elif fault is not None:
        sv.hs_step = hs_wrong
    return lambda: [setattr(sv, k, v) for k, v in real.items()]


def step_batch(torch, model, seed):
    """A batch of the model's HS and NEG steps at its shapes (B=batch_size,
    S=1, L its longest code, K its negatives) on the card: source and target
    ids drawn from the vocab, negatives from its table."""
    import numpy as np

    rng = np.random.default_rng(seed)
    B, V = model.batch_size, model.vocab.num_words()
    src = rng.integers(0, V, (B, 1))
    tgt = rng.integers(0, V, B)
    negs = model.lookup.sample_negatives(rng, (B, model.negative))

    def put(a, dt=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=DEVICE)

    return dict(src=put(src), src_mask=put(np.ones((B, 1)), torch.float32), tgt=put(tgt),
                negs=put(negs), points=put(model._points_arr[tgt]),
                codes=put(model._codes_arr[tgt], torch.float32),
                code_mask=put(model._code_mask[tgt], torch.float32))


def time_w2v_steps(torch, sv, model) -> dict:
    """ms of one HS step and one NEG step (CUDA events, median) at the
    model's batch, on copies of its tables."""
    b = step_batch(torch, model, SEED + 61)
    lk = model.lookup
    t = {k: torch.tensor(getattr(lk, k), device=DEVICE) for k in ("syn0", "syn1", "syn1neg")}
    bufs = {k: torch.zeros_like(v) for k, v in t.items()}
    lr = 1e-3
    hs = median_ms(lambda: sv.hs_step(t["syn0"], t["syn1"], (bufs["syn0"], bufs["syn1"]),
                                      b["src"], b["src_mask"], b["points"], b["codes"],
                                      b["code_mask"], lr), reps=21, warmup=3)
    neg = median_ms(lambda: sv.neg_step(t["syn0"], t["syn1neg"], (bufs["syn0"], bufs["syn1neg"]),
                                        b["src"], b["src_mask"], b["tgt"], b["negs"], lr),
                    reps=21, warmup=3)
    return {"hs_step_ms": hs, "neg_step_ms": neg, "B": model.batch_size,
            "L": model._max_code, "K": model.negative, "D": model.layer_size}


def formats_roundtrip(model, tmp: str) -> dict:
    """The C text, C binary and zip formats written and read back: the zip's
    tables and codes and the binary's vectors equal, the text's within its
    6 decimals; the zip restored on the card and fit on."""
    import numpy as np

    from deeplearning4j_tpu_torch.nlp import (load_txt_vectors, read_binary_model,
                                              read_sequence_vectors, write_binary_model,
                                              write_sequence_vectors, write_word_vectors)

    lk, words = model.lookup, model.vocab.words()
    paths = {k: os.path.join(tmp, f"w2v.{k}") for k in ("txt", "bin", "zip")}
    write_word_vectors(lk, paths["txt"])
    write_binary_model(lk, paths["bin"])
    write_sequence_vectors(model, paths["zip"])
    txt, binary = load_txt_vectors(paths["txt"]), read_binary_model(paths["bin"])
    z = read_sequence_vectors(paths["zip"], device=DEVICE)
    out = {"bytes": {k: os.path.getsize(p) for k, p in paths.items()},
           "text_max_abs": float(np.abs(txt.syn0 - lk.syn0).max()),
           "text_words": txt.vocab.words() == words,
           "binary_equal": bool(np.array_equal(binary.syn0, lk.syn0))
           and binary.vocab.words() == words,
           "zip_equal": all(np.array_equal(getattr(z.lookup, k), getattr(lk, k))
                            for k in ("syn0", "syn1", "syn1neg"))
           and [(w.codes, w.points) for w in z.vocab.vocab_words()]
           == [(w.codes, w.points) for w in model.vocab.vocab_words()]}
    z.fit([model.vocab.words()[:NLP_LEN]] * 8)  # restored, then trained on
    out["zip_fit_on_finite"] = bool(np.isfinite(z.lookup.syn0).all())
    text_limit = W2V_TEXT_ATOL + float(np.spacing(np.abs(lk.syn0).max())) / 2
    out["text_limit"] = text_limit
    out["ok"] = (out["text_max_abs"] <= text_limit and out["text_words"]
                 and out["binary_equal"] and out["zip_equal"] and out["zip_fit_on_finite"])
    return out


def failed(checks: dict) -> list:
    return [k for k, v in checks.items() if not v]


def phase_nlp_word2vec(torch, card):
    """Word2Vec at 300 dimensions (W2V) on the seeded corpus: the head fit
    on the card against the CPU, twice on the card, and with each of
    W2V_FAULTS (each must fall outside W2V_TABLE_REL); the whole corpus on
    the card (words/s, peak MiB, planted-topic recall); the three formats;
    the HS and NEG steps timed; a profiled fit's idle share. Returns
    (the fitted model, the corpus, readings)."""
    import tempfile

    import numpy as np

    from deeplearning4j_tpu_torch.nlp import Word2Vec
    from deeplearning4j_tpu_torch.nlp import sequence_vectors as sv

    t_phase = time.perf_counter()
    corpus = nlp_corpus(SEED + 60)
    sents = corpus["sentences"]
    head = sents[:W2V_CPU_SENTENCES]

    def fit_head(dev, fault=None):
        undo = w2v_fault(sv, fault)
        try:
            return Word2Vec(device=dev, **W2V).fit(head)
        finally:
            undo()

    t0 = time.perf_counter()
    cpu = fit_head("cpu")
    cpu_s = time.perf_counter() - t0
    runs = [fit_head(DEVICE) for _ in range(2)]
    heads_s = time.perf_counter() - t0 - cpu_s
    rel = table_rel(runs[0], cpu)
    card_vs_card = table_rel(runs[1], runs[0])
    faults = {}
    for f in W2V_FAULTS:
        r = table_rel(fit_head(DEVICE, f), cpu)
        faults[f] = {"readings": r, "caught": max(r.values()) > W2V_TABLE_REL}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = Word2Vec(device=DEVICE, **W2V)
    t0 = time.perf_counter()
    model.fit(sents)
    fit_s = time.perf_counter() - t0
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    t0 = time.perf_counter()
    recall = topic_recall(model.lookup)
    recall_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        formats = formats_roundtrip(model, tmp)
    formats_s = time.perf_counter() - t0 - recall_s
    steps = time_w2v_steps(torch, sv, model)
    prof = profile(torch, lambda: Word2Vec(device=DEVICE, **W2V).fit(
        sents[:W2V_PROFILED_SENTENCES]), top=8)
    checks = {"card_vs_cpu": max(rel.values()) <= W2V_TABLE_REL,
              **{f"fault_{f}_caught": v["caught"] for f, v in faults.items()},
              "topic_recall": recall >= W2V_RECALL_PIN, "formats": formats["ok"],
              "finite": bool(all(np.isfinite(getattr(model.lookup, k)).all()
                                 for k in ("syn0", "syn1", "syn1neg")))}
    readings = dict(
        vocab=model.vocab.num_words(), huffman_depth=model._max_code,
        tokens=sum(len(s) for s in sents), head_sentences=W2V_CPU_SENTENCES,
        readings_vs_cpu=rel, card_vs_card=card_vs_card, limit=W2V_TABLE_REL, faults=faults,
        cpu_head_fit_s=cpu_s, card_head_fits_s=heads_s, fit_s=fit_s,
        words_per_s=model.last_words_per_sec,
        peak_allocated_mib=peak_mib, topic_recall=recall, recall_pin=W2V_RECALL_PIN,
        recall_s=recall_s, formats=formats, formats_s=formats_s, steps=steps,
        profiled={"sentences": W2V_PROFILED_SENTENCES, "wall_ms": prof["wall_ms"],
                  "device_busy_ms": prof["device_busy_ms"], "idle_share": prof["idle_share"],
                  "top_kernels": prof["top_kernels"]},
        phase_s=time.perf_counter() - t_phase)
    emit("nlp_word2vec", **readings, checks=checks, ok=not failed(checks), gpu=card)
    if failed(checks):
        raise AssertionError(f"nlp_word2vec failed its checks: {failed(checks)}")
    return model, corpus, readings


def pv_documents(seed):
    """(training, held out): PV_DOCS and PV_HELD LabelledDocuments of PV_LEN
    tokens, label l's document PV_PLANTED words of topic l among Zipf
    words, shuffled."""
    import numpy as np

    from deeplearning4j_tpu_torch.nlp import LabelledDocument

    rng = np.random.default_rng(seed)
    n = PV_DOCS + PV_HELD
    labels = rng.integers(0, PV_LABELS, n)
    z = nlp_zipf(rng, (n, PV_LEN - PV_PLANTED))
    planted = rng.integers(0, NLP_GROUP_WORDS, (n, PV_PLANTED))
    order = np.argsort(rng.random((n, PV_LEN)), axis=1)
    docs = []
    for i in range(n):
        toks = [f"w{k}" for k in z[i]] + [f"t{labels[i]}_{j}" for j in planted[i]]
        docs.append(LabelledDocument(" ".join(toks[k] for k in order[i]),
                                     [f"label_{labels[i]}"]))
    return docs[:PV_DOCS], docs[PV_DOCS:]


def infer_vector_float64(pv, text, steps: int = 30, learning_rate: float = 0.05):
    """ParagraphVectors.infer_vector's HS steps in float64 numpy, from the
    same start: the scale of f32's rounding in the 30 steps."""
    import numpy as np

    toks = [pv.vocab.word_for(t).index for t in pv.tokenizer_factory.create(text).get_tokens()
            if pv.vocab.contains_word(t)]
    rng = np.random.default_rng(pv.seed)
    v = ((rng.random(pv.layer_size) - 0.5) / pv.layer_size).astype(np.float32).astype(np.float64)
    tgt = np.asarray(toks)
    node = pv.lookup.syn1[pv._points_arr[tgt]].astype(np.float64)
    sign = 1.0 - 2.0 * pv._codes_arr[tgt].astype(np.float64)
    cmask = pv._code_mask[tgt].astype(np.float64)
    for _ in range(steps):
        g = -sign / (1.0 + np.exp(sign * (node @ v))) * cmask
        v = v - learning_rate * (g.reshape(-1) @ node.reshape(-1, pv.layer_size))
    return v


def pv_run(torch, algo, docs, held) -> dict:
    """ParagraphVectors (``algo``) fit on the card: infer_vector on the card
    against the CPU on the same tables, and held-out predict accuracy."""
    import numpy as np

    from deeplearning4j_tpu_torch.nlp import ParagraphVectors

    t0 = time.perf_counter()
    pv = ParagraphVectors(sequence_algo=algo, device=DEVICE, **PV).fit_documents(docs)
    fit_s = time.perf_counter() - t0
    card_dev = pv.device
    got = [pv.infer_vector(d.content) for d in held[:PV_INFER_COMPARED]]
    pv.device = torch.device("cpu")
    want = [pv.infer_vector(d.content) for d in held[:PV_INFER_COMPARED]]
    pv.device = card_dev
    infer_rel = max(float(np.abs(g - w).max() / np.abs(w).max()) for g, w in zip(got, want))
    f64 = [infer_vector_float64(pv, d.content) for d in held[:PV_INFER_COMPARED]]
    cpu_vs_f64 = max(float(np.abs(w - r).max() / np.abs(r).max()) for w, r in zip(want, f64))
    t0 = time.perf_counter()
    right = sum(pv.predict(d.content) == d.labels[0] for d in held)
    predict_s = time.perf_counter() - t0
    return {"fit_s": fit_s, "words_per_s": pv.last_words_per_sec,
            "vocab": pv.vocab.num_words(), "infer_rel_vs_cpu": infer_rel,
            "infer_rel_cpu_vs_float64": cpu_vs_f64,
            "accuracy": right / len(held), "pin": PV_PIN[algo],
            "predict_ms_per_doc": predict_s * 1e3 / len(held)}


def distributed_run(torch, sents) -> dict:
    """DistributedWord2Vec with DIST_WORKERS workers on the card: the
    master's tables against the mean of the workers' (bit for bit, the same
    numpy sum), and each worker against a Word2Vec fit alone on its shard
    from the same tables (W2V_TABLE_REL: the card's atomics)."""
    import copy

    import numpy as np

    from deeplearning4j_tpu_torch.nlp import DistributedWord2Vec, Word2Vec

    spawned = []  # (worker, the tables it starts from)

    class Recording(DistributedWord2Vec):
        def _spawn_worker(self):
            w = super()._spawn_worker()
            spawned.append((w, {k: getattr(w.lookup, k).copy()
                                for k in ("syn0", "syn1", "syn1neg")}))
            return w

    t0 = time.perf_counter()
    dist = Recording(workers=DIST_WORKERS, device=DEVICE, **W2V)
    dist.fit(sents)
    fit_s = time.perf_counter() - t0
    mean_equal = True
    for k in ("syn0", "syn1", "syn1neg"):
        acc = np.zeros_like(getattr(dist.lookup, k))
        for w, _ in spawned:
            acc += getattr(w.lookup, k)
        mean_equal &= bool(np.array_equal(acc / len(spawned), getattr(dist.lookup, k)))
    alone_rel = []
    for i, (w, start) in enumerate(spawned):
        solo = Word2Vec(device=DEVICE, **{**W2V, "seed": dist.seed})
        solo.vocab, solo._max_code = dist.vocab, dist._max_code
        solo._codes_arr, solo._points_arr, solo._code_mask = (
            dist._codes_arr, dist._points_arr, dist._code_mask)
        solo.lookup = copy.copy(dist.lookup)
        for k, v in start.items():
            setattr(solo.lookup, k, v.copy())
        solo.fit(sents[i::DIST_WORKERS])
        alone_rel.append(max(table_rel(w, solo).values()))
    return {"workers": len(spawned), "sentences": len(sents), "fit_s": fit_s,
            "mean_of_workers_equal": mean_equal, "worker_vs_alone_rel": alone_rel}


def phase_nlp_paragraph_vectors_glove(torch, corpus, card):
    """ParagraphVectors (DBOW; DM at window 5) at 300 dimensions on the
    seeded labelled documents, GloVe at the JAX defaults on the corpus's
    first GLOVE_SENTENCES sentences (card against CPU over GLOVE_CPU_EPOCHS
    epochs on the first GLOVE_CPU_SENTENCES; planted-topic recall), and
    DistributedWord2Vec. Returns readings."""
    import numpy as np

    from deeplearning4j_tpu_torch.nlp import Glove

    t_phase = time.perf_counter()
    docs, held = pv_documents(SEED + 62)
    pv = {algo: pv_run(torch, algo, docs, held) for algo in ("dbow", "dm")}
    sents = corpus["sentences"]
    small = dict(GLOVE, epochs=GLOVE_CPU_EPOCHS)
    head = sents[:GLOVE_CPU_SENTENCES]
    g_card = Glove(device=DEVICE, **small).fit(head)
    g_cpu = Glove(device="cpu", **small).fit(head)
    glove_rel = float(np.abs(g_card.lookup.syn0 - g_cpu.lookup.syn0).max()
                      / np.abs(g_cpu.lookup.syn0).max())
    t0 = time.perf_counter()
    glove = Glove(device=DEVICE, **GLOVE).fit(sents[:GLOVE_SENTENCES])
    glove_s = time.perf_counter() - t0
    glove_recall = topic_recall(glove.lookup)
    dist = distributed_run(torch, sents[:DIST_SENTENCES])
    checks = {**{f"pv_{a}_infer_vs_cpu": r["infer_rel_vs_cpu"] <= PV_INFER_REL
                 for a, r in pv.items()},
              **{f"pv_{a}_accuracy": r["accuracy"] >= r["pin"] for a, r in pv.items()},
              "glove_vs_cpu": glove_rel <= GLOVE_REL,
              "glove_recall": glove_recall >= GLOVE_RECALL_PIN,
              "glove_finite": bool(np.isfinite(glove.lookup.syn0).all()),
              "distributed_mean": dist["mean_of_workers_equal"],
              "distributed_workers_alone": max(dist["worker_vs_alone_rel"]) <= W2V_TABLE_REL}
    readings = dict(
        paragraph_vectors=pv, pv_docs=PV_DOCS, pv_held=PV_HELD, pv_infer_limit=PV_INFER_REL,
        glove={"tokens": sum(len(s) for s in sents[:GLOVE_SENTENCES]),
               "vocab": glove.vocab.num_words(), "epochs": GLOVE["epochs"],
               "fit_s": glove_s, "rel_vs_cpu": glove_rel, "limit": GLOVE_REL,
               "cpu_tokens": sum(len(s) for s in head), "cpu_epochs": GLOVE_CPU_EPOCHS,
               "topic_recall": glove_recall, "recall_pin": GLOVE_RECALL_PIN},
        distributed=dist, phase_s=time.perf_counter() - t_phase)
    emit("nlp_paragraph_vectors_glove", **readings, checks=checks, ok=not failed(checks),
         gpu=card)
    if failed(checks):
        raise AssertionError(f"nlp_paragraph_vectors_glove failed its checks: {failed(checks)}")
    return readings


def sbm_edges(seed):
    """(edges [E, 2], each vertex's group): DW_VERTICES vertices in
    DW_GROUPS groups of near-equal size, about DW_EDGES distinct undirected
    edges, DW_INSIDE of them inside a group (each pair of a group an edge
    with one probability, the rest drawn uniformly across groups)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    group = rng.permutation(np.arange(DW_VERTICES) % DW_GROUPS)
    members = [np.flatnonzero(group == g) for g in range(DW_GROUPS)]
    pairs_in = sum(len(m) * (len(m) - 1) // 2 for m in members)
    p_in = DW_INSIDE * DW_EDGES / pairs_in
    edges = []
    for m in members:
        iu = np.triu_indices(len(m), 1)
        keep = rng.random(len(iu[0])) < p_in
        edges.append(np.stack([m[iu[0][keep]], m[iu[1][keep]]], 1))
    n_out = int(round((1 - DW_INSIDE) * DW_EDGES))
    cand = rng.integers(0, DW_VERTICES, (2 * n_out, 2))
    cand = cand[group[cand[:, 0]] != group[cand[:, 1]]]
    cand = np.unique(np.sort(cand, 1), axis=0)
    edges.append(cand[rng.permutation(len(cand))[:n_out]])
    return np.concatenate(edges), group


def community_recall(vectors, group, seed) -> float:
    """The mean share of a vertex's 10 nearest vertices (cosine) in its own
    group, over DW_RECALL_SAMPLE vertices drawn from the seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    v = vectors / np.maximum(np.linalg.norm(vectors, axis=1, keepdims=True), 1e-12)
    idx = rng.choice(len(v), DW_RECALL_SAMPLE, replace=False)
    sims = v[idx] @ v.T
    sims[np.arange(len(idx)), idx] = -np.inf
    near = np.argpartition(-sims, W2V_NEAREST, axis=1)[:, :W2V_NEAREST]
    return float((group[near] == group[idx][:, None]).mean())


def phase_graph_deepwalk(torch, card):
    """DeepWalk at BlogCatalog's size: the SBM written as an edge list and
    read through graph_embeddings.loader; DeepWalk(DW).fit on the card; its
    first DW_CPU_WALKS walks fit on the card against the CPU; community
    recall among the 10 nearest vertices; GraphVectors saved and loaded."""
    import tempfile

    import numpy as np

    from deeplearning4j_tpu_torch.graph_embeddings import (DeepWalk, GraphVectors,
                                                           RandomWalkIterator,
                                                           load_undirected_graph_edge_list)

    t_phase = time.perf_counter()
    edges, group = sbm_edges(SEED + 63)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "blogcatalog_sbm.edges")
        np.savetxt(path, edges, fmt="%d")
        t0 = time.perf_counter()
        graph = load_undirected_graph_edge_list(path, DW_VERTICES)
        load_s = time.perf_counter() - t0
        it = RandomWalkIterator(graph, DW["walk_length"], seed=SEED)
        head = [it.next_walk() for _ in range(DW_CPU_WALKS)]
        small = {dev: DeepWalk(device=dev, seed=SEED, **DW).fit_walks(graph, head)
                 for dev in ("cpu", DEVICE)}
        small_rel = float(np.abs(small[DEVICE].vectors - small["cpu"].vectors).max()
                          / np.abs(small["cpu"].vectors).max())
        dw = DeepWalk(device=DEVICE, seed=SEED, **DW)
        t0 = time.perf_counter()
        gv = dw.fit(graph)
        fit_s = time.perf_counter() - t0
        engine = dw._engine
        gv.save(os.path.join(tmp, "vectors"))
        back = GraphVectors.load(os.path.join(tmp, "vectors"), graph)
        saved_equal = bool(np.array_equal(back.vectors, gv.vectors))
    recall = community_recall(gv.vectors, group, SEED + 64)
    degrees = np.array([graph.get_vertex_degree(i) for i in range(DW_VERTICES)])
    checks = {"card_vs_cpu": small_rel <= DW_REL, "community_recall": recall >= DW_RECALL_PIN,
              "saved_equal": saved_equal, "finite": bool(np.isfinite(gv.vectors).all()),
              "every_vertex_trained": engine.vocab.num_words() == DW_VERTICES}
    readings = dict(
        vertices=DW_VERTICES, groups=DW_GROUPS, edges=int(degrees.sum() // 2),
        inside_share=float((group[edges[:, 0]] == group[edges[:, 1]]).mean()),
        load_s=load_s, walks=DW_VERTICES * DW["walks_per_vertex"], settings=DW,
        huffman_depth=engine._max_code, fit_s=fit_s, words_per_s=engine.last_words_per_sec,
        cpu_walks=DW_CPU_WALKS, rel_vs_cpu=small_rel, limit=DW_REL,
        community_recall=recall, recall_pin=DW_RECALL_PIN,
        phase_s=time.perf_counter() - t_phase)
    emit("graph_deepwalk", **readings, checks=checks, ok=not failed(checks), gpu=card)
    if failed(checks):
        raise AssertionError(f"graph_deepwalk failed its checks: {failed(checks)}")
    return readings


def sentiment_reviews(n, lengths, seed):
    """n (review, "pos" or "neg") pairs: lengths drawn in ``lengths``, Zipf
    words with one in SENT_DENSITY (at random places) a word of the
    review's planted polarity."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pol = int(rng.integers(0, NLP_POLARITIES))
        L = int(rng.integers(lengths[0], lengths[1] + 1))
        toks = [f"w{k}" for k in nlp_zipf(rng, L)]
        for i in np.flatnonzero(rng.random(L) < 1.0 / SENT_DENSITY):
            toks[i] = f"p{pol}_{int(rng.integers(0, NLP_GROUP_WORDS))}"
        out.append((" ".join(toks), ("neg", "pos")[pol]))
    return out


def sentiment_conf():
    """GravesLSTM(300 -> 256, tanh) -> RnnOutputLayer(softmax, MCXENT, 2),
    Adam at SENT_LR with ClipElementWiseAbsoluteValue at 1.0, l2 SENT_L2."""
    from deeplearning4j_tpu_torch import (GravesLSTM, InputType, MultiLayerConfiguration,
                                          RnnOutputLayer)

    return MultiLayerConfiguration(
        layers=[GravesLSTM(n_in=W2V["layer_size"], n_out=SENT_H, activation="tanh",
                           weight_init="xavier", l2=SENT_L2),
                RnnOutputLayer(n_in=SENT_H, n_out=2, activation="softmax", loss="mcxent",
                               weight_init="xavier", l2=SENT_L2)],
        input_type=InputType.recurrent(W2V["layer_size"]),
        updater={"updater": "adam", "learning_rate": SENT_LR,
                 "gradient_normalization": "ClipElementWiseAbsoluteValue",
                 "gradient_normalization_threshold": 1.0},
        seed=SEED)


def sentiment_params(seed) -> list:
    """Xavier (normal, 2 / (fan_in + fan_out)) weights from a numpy seed,
    zero biases but the forget gate's 1, zero peepholes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    D, H = W2V["layer_size"], SENT_H

    def w(shape, fan_in, fan_out):
        return rng.normal(0.0, (2.0 / (fan_in + fan_out)) ** 0.5, shape)

    b = np.zeros(4 * H)
    b[H:2 * H] = 1.0
    return [{"W": w((D, 4 * H), D, H), "RW": w((H, 4 * H), H, H), "b": b,
             "pF": np.zeros(H), "pI": np.zeros(H), "pO": np.zeros(H)},
            {"W": w((H, 2), H, 2), "b": np.zeros(2)}]


def labels_at_last_real_step(ds) -> bool:
    """Each row's label and labels mask at its last real step alone (the
    features mask's last 1), a one-hot label there."""
    import numpy as np

    last = ds.features_mask.sum(1).astype(int) - 1
    rows = np.arange(len(last))
    want = np.zeros_like(ds.labels_mask)
    want[rows, last] = 1.0
    return bool(np.array_equal(ds.labels_mask, want)
                and np.array_equal(ds.labels[rows, last].sum(-1), np.ones(len(last))))


def padded_last_step(it_cls):
    """A wrong Word2VecDataSetIterator: each label at the batch's last
    (padded) step, not the row's last real one."""
    from deeplearning4j_tpu_torch import DataSet

    class Wrong(it_cls):
        def __iter__(self):
            for ds in super().__iter__():
                y, m = ds.labels.copy(), ds.labels_mask.copy()
                lab = y.sum(1)
                y[:] = 0.0
                y[:, -1] = lab
                m[:] = 0.0
                m[:, -1] = 1.0
                yield DataSet(ds.features, y, features_mask=ds.features_mask, labels_mask=m)

    return Wrong


def sentiment_accuracy(net, it) -> float:
    """Held-out accuracy at each review's last real step."""
    import numpy as np

    right = total = 0
    for ds in it:
        out = net.output(ds.features, features_mask=ds.features_mask)
        last = ds.features_mask.sum(1).astype(int) - 1
        rows = np.arange(len(last))
        right += int((out[rows, last].argmax(-1) == ds.labels[rows, last].argmax(-1)).sum())
        total += len(last)
    return right / total


def phase_w2v_sentiment(torch, w2v, card):
    """DL4J's Word2VecSentimentRNN on phase nlp_word2vec's 300-d vectors:
    the iterator's arrays checked (a wrong iterator with the labels at the
    padded last step caught); the first 2 updates at SENT_CPU's smaller T on
    the card against the CPU at RECIPE_LIMITS (and with the wrong iterator,
    reported); SENT_EPOCHS epochs on the card with exact launches of rows
    8-12; held-out accuracy; ms per update. Returns (launches, the long
    batch's mask [T, B, 1], the net's leaf shapes, readings)."""
    import numpy as np

    from deeplearning4j_tpu_torch import (MultiLayerNetwork, load_jax_params, ops,
                                          params_to_numpy)
    from deeplearning4j_tpu_torch.nlp import Word2VecDataSetIterator

    t_phase = time.perf_counter()
    conf, host = sentiment_conf(), sentiment_params(SEED + 65)
    reviews = sentiment_reviews(SENT_TRAIN + SENT_HELD, SENT_LENGTHS, SEED + 66)
    t0 = time.perf_counter()
    train = list(Word2VecDataSetIterator(reviews[:SENT_TRAIN], w2v, batch=SENT_B,
                                         max_length=SENT_T, labels=["neg", "pos"]))
    held = list(Word2VecDataSetIterator(reviews[SENT_TRAIN:], w2v, batch=SENT_B,
                                        max_length=SENT_T, labels=["neg", "pos"]))
    encode_s = time.perf_counter() - t0
    Wrong = padded_last_step(Word2VecDataSetIterator)
    iterator_ok = all(labels_at_last_real_step(ds) for ds in train + held)
    wrong_caught = not all(labels_at_last_real_step(ds) for ds in Wrong(
        reviews[:SENT_B], w2v, batch=SENT_B, max_length=SENT_T, labels=["neg", "pos"]))

    small = sentiment_reviews(SENT_CPU["reviews"], SENT_CPU["lengths"], SEED + 67)

    def small_run(dev, cls=Word2VecDataSetIterator):
        net = load_jax_params(MultiLayerNetwork(conf, device=dev), host)
        rec = LossRecorder()
        net.set_listeners(rec)
        net.fit(list(cls(small, w2v, batch=SENT_B, max_length=SENT_CPU["max_length"],
                         labels=["neg", "pos"])))
        net.set_listeners()
        return net, np.array([float(l) for l in rec.losses]), params_to_numpy(net)

    cpu = small_run("cpu")
    readings = recipe_readings(small_run(DEVICE), cpu, host, lr=SENT_LR)
    lim = SENT_LIMITS
    wrong_readings = recipe_readings(small_run(DEVICE, Wrong), cpu, host, lr=SENT_LR)

    net = load_jax_params(MultiLayerNetwork(conf), host)
    updates = SENT_EPOCHS * len(train)
    torch.cuda.synchronize()
    ops.reset_counters()
    net.fit(train, epochs=SENT_EPOCHS)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.counters().items() if v}
    expected = {"lstm_seq_masked_train_fwd": updates, "lstm_seq_masked_bwd": updates,
                "drw_product": updates, "softmax_xent_fwd": updates,
                "softmax_xent_bwd": updates, "adam_update": updates * adam_launches(net)}
    accuracy = sentiment_accuracy(net, held)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(train)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(train)
    long_batch = max(train, key=lambda ds: ds.features_mask.sum())
    mask = np.ascontiguousarray(np.asarray(long_batch.features_mask, np.float32).T[..., None])
    checks = {"iterator_label_at_last_real_step": iterator_ok,
              "fault_label_at_padded_step_caught": wrong_caught,
              "card_vs_cpu": within_limits(readings, lim), "launches": launches == expected,
              "accuracy": accuracy >= SENT_PIN}
    out = dict(
        train=SENT_TRAIN, held=SENT_HELD, B=SENT_B, T=SENT_T, H=SENT_H,
        encode_s=encode_s, compared=SENT_CPU, readings_vs_cpu=readings, limits=lim,
        cpu_losses=cpu[1].tolist(),
        label_at_padded_step_vs_cpu=wrong_readings,
        label_at_padded_step_within_limits=within_limits(wrong_readings, lim),
        updates=updates, kernel_launches=launches, expected_launches=expected,
        accuracy=accuracy, pin=SENT_PIN, ms_per_update=ms,
        mask_live_share=float(mask.mean()), phase_s=time.perf_counter() - t_phase)
    emit("w2v_sentiment", **out, checks=checks, ok=not failed(checks), gpu=card)
    if failed(checks):
        raise AssertionError(f"w2v_sentiment failed its checks: {failed(checks)}")
    leaf_shapes = [np.shape(p[k]) for p in params_to_numpy(net) for k in p]
    return launches, mask, leaf_shapes, out


def phases_slice24(torch, card):
    """The four phases of slice 24, each counting from 0 where it counts.
    Returns (the sentiment path's launches, its mask, its leaf shapes,
    readings by phase)."""
    model, corpus, w2v = phase_nlp_word2vec(torch, card)
    pvg = phase_nlp_paragraph_vectors_glove(torch, corpus, card)
    dw = phase_graph_deepwalk(torch, card)
    launches, mask, shapes, sent = phase_w2v_sentiment(torch, model, card)
    return launches, mask, shapes, {"nlp_word2vec": w2v, "nlp_paragraph_vectors_glove": pvg,
                                    "graph_deepwalk": dw, "w2v_sentiment": sent}


def kernels_slice24(torch, ls, sx, ad, card, mask, leaf_shapes) -> dict:
    """Rows 8-9 and dRW at the sentiment LSTM's shape (T=256, B=64, H=256)
    under its longest batch's mask, rows 10-11 at its N = B*T rows over 2
    classes, row 12 at its 8 leaves: each against its plain version, then
    timed. Returns {kernel: (max abs err, times, shape)}."""
    out = {}
    T, B = mask.shape[0], mask.shape[1]
    m = torch.as_tensor(mask, device=DEVICE).contiguous()
    shape = f"T={T} B={B} H={SENT_H}, the longest batch's mask"
    for k, (err, t) in lstm_rows_at(torch, ls, T, B, SENT_H, card, "w2v_sentiment",
                                    mask=m).items():
        out[k] = (err, t, shape + (f" R={T * B}" if k == "drw_product" else ""))
    N = B * T
    e = sxent_case(torch, sx, N, 2, "float32", "one_hot", SEED + N)
    for (k, _), t in time_sxent(torch, sx, N, 2, ("float32",), card,
                                "the sentiment net's loss head").items():
        out[k] = (e["loss"] if k.endswith("fwd") else max(e["dx"], e["dl"]), t, f"N={N} C=2")
    _, sc = adam_inputs(torch, SEED)
    leaves, _ = adam_inputs(torch, SEED + 70, leaf_shapes)
    err = adam_check(torch, ad, "w2v_sentiment", leaves, sc)
    out["adam_update"] = (err, time_adam(torch, ad, card, leaf_shapes,
                                         f"the sentiment net's {len(leaf_shapes)} leaves"),
                          f"{len(leaf_shapes)} leaves")
    return out


# ---- slice 25: Keras model import and the Keras gateway. Archives are
# written from the seed by scripts/torch_write_keras_h5.py (numpy, no
# h5py) and read by the port's own HDF5 reader. (a) the LSTM text generator
# of Keras's examples/lstm_text_generation.py in its Keras 1.2 form (LSTM(128)
# over 40 one-hot characters of 57, Dense(57), softmax; RMSprop(lr=0.01),
# categorical cross-entropy, batch 128); (b) VGG16 of the zoo at 224x224x3,
# 1000 classes, from a weights-only 'th' archive in the canonical layout;
# (c) the Keras gateway serving model (a)'s JSON with an Adam training
# config (examples/keras_import.py:37-40).
KERAS_CHARS, KERAS_MAXLEN, KERAS_UNITS, KERAS_B = 57, 40, 128, 128
KERAS_GEN_CHARS = 100  # the example's generation loop: one output() of the last 40 a char
KERAS_UPDATES = 4  # RMSprop updates at B=128 (card against CPU)
KERAS_RMSPROP = {"lr": 0.01, "rho": 0.9, "epsilon": 1e-08, "decay": 0.0}
KERAS_ADAM = {"lr": 1e-3, "beta_1": 0.9, "beta_2": 0.999, "epsilon": 1e-08, "decay": 0.0}
VGG_SIDE, VGG_CLASSES = 224, 1000
VGG_SERVE_B, VGG_TRAIN_B, VGG_CPU_B, VGG_UPDATES = 64, 32, 2, 3
# the fine-tuning rate: the zoo conf's Nesterov rate (0.01, for training from
# scratch) takes these random weights to NaN in the phase's 4th update, on
# the card and on the CPU alike (scripts/torch_vgg16_lr_check.py: losses
# 8.61, 602.0, 3.4e8, NaN on both); a fine-tune takes a tenth of it
VGG_LR = 1e-3
GATEWAY_FITS = 4  # the client's fit calls, a batch of KERAS_B windows each
# Each reading against its limit. Served outputs are read as log
# probabilities (max |log p - log p_ref|: the logits' difference, whatever
# the softmax's spread). Oracles share no code with the importer: a float64
# numpy Keras 1 LSTM from the archive's raw arrays (gates i, f, c, o;
# hard_sigmoid; no peepholes) and a CPU F.conv2d VGG16 in NCHW over the raw
# OIHW kernels and a C,H,W flatten. Card against the port's CPU: outputs,
# each update's loss relative to the CPU's and each tensor's change
# relative to the norm of the CPU's change (train_readings). The wrong
# versions (gate blocks in Keras's [i, f, c, o] order, sigmoid gates, the
# flatten permutation skipped) must read at least KERAS_FAULT_FACTOR times
# past their limit. Read on the H100 (NVIDIA H100 80GB HBM3, 700.00 W; two
# runs, the same numbers): the text generator 1.9e-7 against the oracle and
# 3.5e-7 against the CPU, its wrong versions 0.31 (gate order) and 0.087
# (sigmoid); 4 RMSprop updates loss 1.2e-7, first change 6.5e-7, last 8.9e-6;
# VGG16 7.4e-6 and 8.9e-6, the skipped flatten 2.5; its first update's loss
# 3.3e-7 and change 4.2e-3 (the first conv's kernel: cuDNN's f32 algorithms
# on the card against oneDNN's on the CPU through 16 layers); the gateway's
# losses 1.2e-7, predictions 3.4e-7, score 0. Each limit sits 5-25x above.
KERAS_LIMITS = {
    "lstm_vs_keras_oracle": 5e-6, "lstm_vs_cpu": 5e-6,
    "vgg16_vs_conv_oracle": 1e-4, "vgg16_vs_cpu": 1e-4,
    "lstm_train": {"loss_rel": 5e-6, "first_change_rel": 1e-5, "change_rel": 1e-4},
    "vgg16_train": {"loss_rel": 5e-6, "first_change_rel": 2e-2},
    "gateway": {"loss_rel": 5e-6, "predict": 5e-6, "score_rel": 5e-6},
}
KERAS_FAULT_FACTOR = 10.0
# rows of the kernels line at this slice's shapes: (kernel, shape) -> the
# paths whose launches it counts. The served forward pads T=40 to its
# power-of-two bucket, 64, under a mask of the 40 live steps, so row 5
# serves masked there; fit takes the batch as it is (rows 6-7 at T=40), and
# so does the score of the gateway's evaluate (row 5 unmasked at T=40)
SLICE25_ROWS = {
    ("lstm_seq_lean_masked", "T=64 B=128 H=128, 40 live steps"): ("text_serve", "gateway"),
    ("lstm_seq_lean_masked", "T=64 B=1 H=128, 40 live steps"): ("text_generate",),
    ("lstm_seq_lean", "T=40 B=128 H=128"): ("gateway",),
    ("lstm_seq_train_fwd", "T=40 B=128 H=128"): ("text_train", "gateway"),
    ("lstm_seq_bwd", "T=40 B=128 H=128"): ("text_train", "gateway"),
    ("drw_product", "R=5120 H=128"): ("text_train", "gateway"),
    ("softmax_xent_fwd", "N=128 C=57"): ("text_train", "gateway"),
    ("softmax_xent_bwd", "N=128 C=57"): ("text_train", "gateway"),
    ("softmax_xent_fwd", "N=32 C=1000"): ("vgg16_train",),
    ("softmax_xent_bwd", "N=32 C=1000"): ("vgg16_train",),
    ("adam_update", "8 leaves"): ("gateway",),
}


def keras_writer():
    """scripts/torch_write_keras_h5.py, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "torch_write_keras_h5", os.path.join(HERE, "scripts", "torch_write_keras_h5.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def h5_read_back(path: str, group) -> dict:
    """Every attribute and array the writer was given (``group``, its
    Group tree), read back by the port's reader: counts and mismatches."""
    import numpy as np

    from deeplearning4j_tpu_torch.modelimport import hdf5

    seen = {"attributes": 0, "arrays": 0, "bytes": 0, "mismatches": []}

    def walk(spec, node, where):
        for k, v in spec.attrs.items():
            got = node.attrs.get(k)
            want = v.encode() if isinstance(v, str) else v
            seen["attributes"] += 1
            if got is None or not np.array_equal(np.asarray(got), np.asarray(want)):
                seen["mismatches"].append(f"{where}@{k}")
        for k, v in spec.items():
            if hasattr(v, "attrs"):
                walk(v, node[k], f"{where}/{k}")
            else:
                arr = node[k].read()
                seen["arrays"] += 1
                seen["bytes"] += arr.nbytes
                if arr.dtype != v.dtype or not np.array_equal(arr, v):
                    seen["mismatches"].append(f"{where}/{k}")

    with hdf5.File(path) as f:
        walk(group, f, "")
    return seen


def text_generator_archive(W, seed):
    """Model (a) as Keras 1.2 saves it (Keras's own initializers: W
    glorot_uniform, U orthogonal, b zeros but the forget gate's ones, the
    Dense glorot_uniform): (model_config, training_config, layer weights,
    the writer's Group)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    C, H = KERAS_CHARS, KERAS_UNITS
    mc = {"class_name": "Sequential", "config": [
        {"class_name": "LSTM", "config": {
            "name": "lstm_1", "trainable": True, "batch_input_shape": [None, KERAS_MAXLEN, C],
            "input_dtype": "float32", "return_sequences": False, "go_backwards": False,
            "stateful": False, "unroll": False, "consume_less": "cpu", "input_dim": C,
            "input_length": None, "output_dim": H, "init": "glorot_uniform",
            "inner_init": "orthogonal", "forget_bias_init": "one", "activation": "tanh",
            "inner_activation": "hard_sigmoid", "W_regularizer": None, "U_regularizer": None,
            "b_regularizer": None, "dropout_W": 0.0, "dropout_U": 0.0}},
        {"class_name": "Dense", "config": {
            "name": "dense_1", "trainable": True, "output_dim": C, "init": "glorot_uniform",
            "activation": "linear", "W_regularizer": None, "b_regularizer": None,
            "activity_regularizer": None, "W_constraint": None, "b_constraint": None,
            "bias": True, "input_dim": H}},
        {"class_name": "Activation", "config": {"name": "activation_1", "trainable": True,
                                                "activation": "softmax"}}]}
    tc = {"optimizer_config": {"class_name": "RMSprop", "config": dict(KERAS_RMSPROP)},
          "loss": "categorical_crossentropy", "metrics": [], "sample_weight_mode": None,
          "loss_weights": None}

    def glorot(n_in, n_out):
        s = (6.0 / (n_in + n_out)) ** 0.5
        return rng.uniform(-s, s, (n_in, n_out)).astype(np.float32)

    lstm = []
    for g in ("i", "c", "f", "o"):
        q, _ = np.linalg.qr(rng.normal(size=(H, H)))
        lstm += [(f"lstm_1_W_{g}", glorot(C, H)), (f"lstm_1_U_{g}", q.astype(np.float32)),
                 (f"lstm_1_b_{g}", np.full(H, 1.0 if g == "f" else 0.0, np.float32))]
    lw = {"lstm_1": lstm, "dense_1": [("dense_1_W", glorot(H, C)),
                                      ("dense_1_b", np.zeros(C, np.float32))],
          "activation_1": []}
    return mc, tc, lw, W.keras_model_archive(mc, tc, lw)


def keras1_lstm_logp(lw, x):
    """log p of model (a) in float64 numpy from the archive's raw arrays:
    Keras 1's LSTM (gates i, f, c, o; hard_sigmoid = clip(0.2x + 0.5, 0,
    1); tanh; no peepholes) and the Dense + softmax head."""
    import numpy as np

    w = {k[len("lstm_1_"):]: a.astype(np.float64) for k, a in lw["lstm_1"]}
    hs = lambda z: np.clip(0.2 * z + 0.5, 0.0, 1.0)  # noqa: E731
    h = np.zeros((x.shape[0], KERAS_UNITS))
    c = np.zeros_like(h)
    for t in range(x.shape[1]):
        xt = x[:, t].astype(np.float64)
        i = hs(xt @ w["W_i"] + h @ w["U_i"] + w["b_i"])
        f = hs(xt @ w["W_f"] + h @ w["U_f"] + w["b_f"])
        c = f * c + i * np.tanh(xt @ w["W_c"] + h @ w["U_c"] + w["b_c"])
        o = hs(xt @ w["W_o"] + h @ w["U_o"] + w["b_o"])
        h = o * np.tanh(c)
    (_, dw), (_, db) = lw["dense_1"]
    z = h @ dw.astype(np.float64) + db.astype(np.float64)
    z -= z.max(-1, keepdims=True)
    return z - np.log(np.exp(z).sum(-1, keepdims=True))


def logp_err(probs, ref_logp) -> float:
    """max |log p - log p_ref| of served probabilities."""
    import numpy as np

    with np.errstate(divide="ignore"):
        return float(np.abs(np.log(np.asarray(probs, np.float64)) - ref_logp).max())


def text_windows(n, seed):
    """``n`` one-hot windows of KERAS_MAXLEN characters and the next
    character's one-hot label, from a seeded text of KERAS_CHARS symbols
    (a repeated sentence, so that there is something to learn)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sentence = rng.integers(0, KERAS_CHARS, 997)
    starts = rng.integers(0, len(sentence), n)
    idx = sentence[(starts[:, None] + np.arange(KERAS_MAXLEN + 1)) % len(sentence)]
    eye = np.eye(KERAS_CHARS, dtype=np.float32)
    return eye[idx[:, :KERAS_MAXLEN]], eye[idx[:, KERAS_MAXLEN]]


def keras_gate_order_wrong(lw):
    """Model (a)'s LSTM params with the gate blocks left in Keras's [i, f,
    c, o] order (the port's are [c, f, o, i]), in the JAX layout."""
    import numpy as np

    w = dict(lw["lstm_1"])
    order = ("i", "f", "c", "o")
    H = KERAS_UNITS
    return {"W": np.concatenate([w[f"lstm_1_W_{g}"] for g in order], 1),
            "RW": np.concatenate([w[f"lstm_1_U_{g}"] for g in order], 1),
            "b": np.concatenate([w[f"lstm_1_b_{g}"] for g in order]),
            "pF": np.zeros(H, np.float32), "pI": np.zeros(H, np.float32),
            "pO": np.zeros(H, np.float32)}


def counted(torch, fn, replays: dict = None):
    """``fn()`` as a ``Windows`` main path: (its result, its launches), the
    wrappers' counts (eager runs, a bucket's warm-up and capture) plus what
    the served graphs launched by replay in it, which also go into
    ``replays``."""
    win = Windows(torch)
    out = win.main(fn)
    if replays is not None:
        replays.update(win.replayed)
    return out, add_counts(win.launches, win.replayed)


def train_run(torch, net, batches):
    """``batches`` one fit each: (losses, params after the first update,
    params after the last) as train_readings takes them."""
    import numpy as np

    from deeplearning4j_tpu_torch import params_to_numpy

    rec = LossRecorder()
    net.set_listeners(rec)
    first = None
    for i, b in enumerate(batches):
        net.fit(b)
        if i == 0:
            first = params_to_numpy(net)
    net.set_listeners()
    return np.array([float(l) for l in rec.losses]), first, params_to_numpy(net)


def phase_keras_text_generator(torch, W, tmp, card):
    """Model (a): its archive written from the seed and read back; imported
    by guess_model and served by output() at B=128, T=40 (against the
    float64 Keras oracle, the CPU, and the two wrong LSTM versions); the
    example's generation loop (100 chars, one output() of the last 40 at
    B=1 each); imported with its training config and trained 4 RMSprop
    updates at B=128 on the card against the CPU. Returns (launches by
    path, readings)."""
    import numpy as np

    from deeplearning4j_tpu_torch import MultiLayerNetwork, load_jax_params, params_to_numpy
    from deeplearning4j_tpu_torch.modelimport import import_keras_sequential_model_and_weights
    from deeplearning4j_tpu_torch.nn.conf.multi_layer import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.utils.model_guesser import guess_model

    t_phase = time.perf_counter()
    lim = KERAS_LIMITS
    mc, tc, lw, group = text_generator_archive(W, SEED + 80)
    path = os.path.join(tmp, "lstm_text_generation.h5")
    t0 = time.perf_counter()
    size = W.write_h5(path, group)
    write_s = time.perf_counter() - t0
    back = h5_read_back(path, group)
    x, _ = text_windows(KERAS_B, SEED + 81)
    oracle = keras1_lstm_logp(lw, x)
    launches, readings, replays = {}, {}, {}

    t0 = time.perf_counter()
    served = guess_model(path)
    import_s = time.perf_counter() - t0
    probs, launches["text_serve"] = counted(torch, lambda: served.output(x),
                                            replays.setdefault("text_serve", {}))
    readings["vs_keras_oracle"] = logp_err(probs, oracle)
    cpu = guess_model(path, device="cpu")
    readings["vs_cpu"] = logp_err(probs, np.log(cpu.output(x).astype(np.float64)))
    # the wrong versions, run on the card as the right one is
    host = params_to_numpy(served)
    wrong_gates = load_jax_params(MultiLayerNetwork(served.conf), [
        keras_gate_order_wrong(lw) if i == 0 else p for i, p in enumerate(host)])
    sig_conf = MultiLayerConfiguration.from_dict(served.conf.to_dict())
    sig_conf.layers[0].gate_activation = "sigmoid"
    wrong_sigmoid = load_jax_params(MultiLayerNetwork(sig_conf), host)
    wrong = {"gate_blocks_keras_order": logp_err(wrong_gates.output(x), oracle),
             "sigmoid_gates": logp_err(wrong_sigmoid.output(x), oracle)}
    del wrong_gates, wrong_sigmoid

    # the example's generation loop: sample the next char from the last 40
    rng = np.random.default_rng(SEED + 82)
    text = list(np.argmax(x[0], -1))
    eye = np.eye(KERAS_CHARS, dtype=np.float32)

    def generate():
        for _ in range(KERAS_GEN_CHARS):
            p = served.output(eye[text[-KERAS_MAXLEN:]][None])[0].astype(np.float64)
            text.append(int(rng.choice(KERAS_CHARS, p=p / p.sum())))

    served.output(eye[text[-KERAS_MAXLEN:]][None])  # the B=1 bucket's capture
    t0 = time.perf_counter()
    _, launches["text_generate"] = counted(torch, generate,
                                          replays.setdefault("text_generate", {}))
    gen_s = time.perf_counter() - t0

    # fine-tuning with the archive's training config: RMSprop, an mcxent head
    batches = [text_windows(KERAS_B, SEED + 83 + i) for i in range(KERAS_UPDATES)]
    net = import_keras_sequential_model_and_weights(path)
    seed_params = params_to_numpy(net)
    run, launches["text_train"] = counted(torch, lambda: train_run(torch, net, batches))
    ref = train_run(torch, import_keras_sequential_model_and_weights(path, device="cpu"),
                    batches)
    train = train_readings(run, ref, seed_params)
    updater = net.conf.updater
    checks = {
        "read_back": not back["mismatches"],
        "vs_keras_oracle": readings["vs_keras_oracle"] <= lim["lstm_vs_keras_oracle"],
        "vs_cpu": readings["vs_cpu"] <= lim["lstm_vs_cpu"],
        "wrong_gate_order_caught": wrong["gate_blocks_keras_order"]
        > KERAS_FAULT_FACTOR * lim["lstm_vs_keras_oracle"],
        "wrong_sigmoid_caught": wrong["sigmoid_gates"]
        > KERAS_FAULT_FACTOR * lim["lstm_vs_keras_oracle"],
        "gate_is_hardsigmoid": net.conf.layers[0].gate_activation == "hardsigmoid",
        "rmsprop": updater["updater"] == "rmsprop" and updater["rms_decay"] == 0.9,
        "generated": len(text) == KERAS_MAXLEN + KERAS_GEN_CHARS,
        "train_vs_cpu": within_limits(train, lim["lstm_train"]),
        "loss_finite": bool(np.isfinite(run[0]).all()),
    }
    out = dict(archive_bytes=size, write_s=write_s, read_back=back, import_s=import_s,
               B=KERAS_B, T=KERAS_MAXLEN, H=KERAS_UNITS, C=KERAS_CHARS,
               readings=readings, wrong_readings=wrong,
               limits={k: lim[k] for k in ("lstm_vs_keras_oracle", "lstm_vs_cpu")},
               fault_factor=KERAS_FAULT_FACTOR, generated_chars=KERAS_GEN_CHARS,
               generate_s=gen_s, chars_per_s=KERAS_GEN_CHARS / gen_s,
               train_readings=train, train_limits=lim["lstm_train"],
               losses=run[0].tolist(), cpu_losses=ref[0].tolist(), launches=launches,
               replayed_launches=replays, phase_s=time.perf_counter() - t_phase)
    emit("keras_text_generator", **out, checks=checks, ok=not failed(checks), gpu=card)
    if failed(checks):
        raise AssertionError(f"keras_text_generator failed its checks: {failed(checks)}")
    return launches, out


def vgg16_th_layers(seed):
    """The canonical VGG16 weights-only archive's 37 layers as (kind,
    arrays): ZeroPadding2D before each 3x3 conv (kernels OIHW, He-scaled),
    the 5 pools, Flatten, Dense and Dropout layers (the first Dense's rows
    in C,H,W flatten order); weightless layers hold no arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def normal(std, shape):
        return np.float32(std) * rng.standard_normal(shape, dtype=np.float32)

    layers, c_in = [], 3
    for block in ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512)):
        for c_out in block:
            layers += [("pad", []), ("conv", [normal((2.0 / (9 * c_in)) ** 0.5,
                                                     (c_out, c_in, 3, 3)),
                                              normal(0.01, c_out)])]
            c_in = c_out
        layers.append(("pool", []))
    layers.append(("flatten", []))
    flat = 512 * (VGG_SIDE // 32) ** 2
    for n_in, n_out in ((flat, 4096), (4096, 4096)):
        layers += [("dense", [normal((2.0 / n_in) ** 0.5, (n_in, n_out)),
                              np.zeros(n_out, np.float32)]), ("dropout", [])]
    layers.append(("dense", [normal(0.01, (4096, VGG_CLASSES)),
                             np.zeros(VGG_CLASSES, np.float32)]))
    return layers


def vgg16_th_logp(torch, layers, x_nhwc):
    """log p of the canonical archive's VGG16 on the CPU, NCHW as Keras 1's
    'th' model runs it: F.pad and valid F.conv2d over the raw OIHW kernels,
    max pools, the C,H,W flatten, the Dense layers (ReLU but the last),
    log_softmax; in float32."""
    import numpy as np

    F = torch.nn.functional
    h = torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))
    dense = [arrs for kind, arrs in layers if kind == "dense"]
    with torch.no_grad():
        for kind, arrs in layers:
            if kind == "pad":
                h = F.pad(h, (1, 1, 1, 1))
            elif kind == "conv":
                h = F.relu(F.conv2d(h, torch.from_numpy(arrs[0]), torch.from_numpy(arrs[1])))
            elif kind == "pool":
                h = F.max_pool2d(h, 2, 2)
            elif kind == "flatten":
                h = h.reshape(h.shape[0], -1)
            elif kind == "dense":
                h = h @ torch.from_numpy(arrs[0]) + torch.from_numpy(arrs[1])
                if arrs is not dense[-1]:
                    h = F.relu(h)
        return F.log_softmax(h.double(), -1).numpy()


def vgg16_images(n, seed):
    """``n`` NHWC images with values in [-1, 1) and one-hot labels of 1000
    classes, float32 host arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (n, VGG_SIDE, VGG_SIDE, 3)).astype(np.float32)
    return x, one_hot(rng.integers(0, VGG_CLASSES, n), VGG_CLASSES)


def phase_keras_vgg16(torch, W, tmp, card):
    """Model (b): the 553 MB weights-only 'th' archive written from the seed
    and read back (MB/s of the reader), loaded by TrainedModels.load; served
    by output() at B=64 eager and replayed; on 2 images against the CPU
    F.conv2d oracle, the port's CPU run and the wrong version with the
    flatten permutation skipped; the first Nesterov update at B=2 against the
    CPU; 3 timed updates at B=32. Returns (launches by path, readings)."""
    import numpy as np

    from deeplearning4j_tpu_torch import MultiLayerNetwork, load_jax_params, params_to_numpy
    from deeplearning4j_tpu_torch.modelimport import TrainedModels, hdf5

    t_phase = time.perf_counter()
    lim = KERAS_LIMITS
    layers = vgg16_th_layers(SEED + 90)
    group = W.keras_weights_archive([arrs for _, arrs in layers])
    path = os.path.join(tmp, "vgg16_weights_th_dim_ordering.h5")
    t0 = time.perf_counter()
    size = W.write_h5(path, group)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hdf5.read_layer_weights(path)
    read_s = time.perf_counter() - t0
    back = h5_read_back(path, group)
    del group
    launches, readings = {}, {}
    t0 = time.perf_counter()
    net = TrainedModels.load("VGG16", path)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    n_params = net.num_params()

    # served at B=64: eager (the yardstick) and replayed
    xs, _ = vgg16_images(VGG_SERVE_B, SEED + 91)
    eager = legacy(lambda: net.output(xs))
    (replayed, again), launches["vgg16_serve"] = counted(
        torch, lambda: (net.output(xs), net.output(xs)))
    eager_runs = legacy(lambda: call_ms(torch, lambda: net.output(xs)))
    replay_runs = call_ms(torch, lambda: net.output(xs))

    # 2 images against the oracle, the CPU and the wrong flatten
    x2 = xs[:VGG_CPU_B]
    oracle = vgg16_th_logp(torch, layers, x2)
    probs = net.output(x2)
    readings["vs_conv_oracle"] = logp_err(probs, oracle)
    host = params_to_numpy(net)
    cpu = load_jax_params(MultiLayerNetwork(net.conf, device="cpu"), host)
    readings["vs_cpu"] = logp_err(probs, np.log(cpu.output(x2).astype(np.float64)))
    first_dense = len(net.conf.layers) - 3
    raw = [arrs for kind, arrs in layers if kind == "dense"][0]
    unpermuted = [dict(p, W=raw[0]) if i == first_dense else p for i, p in enumerate(host)]
    wrong_net = load_jax_params(MultiLayerNetwork(net.conf), unpermuted)
    wrong = {"flatten_permutation_skipped": logp_err(wrong_net.output(x2), oracle)}
    del wrong_net, unpermuted, layers
    gc_collect(torch)

    # fine-tuning at VGG_LR: the first Nesterov update at B=2 against the
    # CPU, then 3 timed at B=32 after one more (the conf is the CPU twin's too)
    net.conf.updater["learning_rate"] = VGG_LR
    _, y2 = vgg16_images(VGG_CPU_B, SEED + 92)
    first, c1 = counted(torch, lambda: train_run(torch, net, [(x2, y2)]))
    ref = train_run(torch, cpu, [(x2, y2)])
    train = train_readings(first, ref, host)
    del cpu, host
    gc_collect(torch)
    xt, yt = vgg16_images(VGG_TRAIN_B, SEED + 93)

    def timed():
        rec = LossRecorder()
        net.set_listeners(rec)
        net.fit((xt, yt))
        torch.cuda.synchronize()
        runs = []
        for _ in range(VGG_UPDATES):
            t0 = time.perf_counter()
            net.fit((xt, yt))
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        net.set_listeners()
        return runs, [float(l) for l in rec.losses]

    (update_runs, losses32), c32 = counted(torch, timed)
    launches["vgg16_train"] = add_counts(dict(c1), c32)
    checks = {
        "read_back": not back["mismatches"] and back["arrays"] == 32,
        "params": n_params == 138357544,
        "replayed_bit_exact": bool(np.array_equal(replayed, eager)
                                   and np.array_equal(again, eager)),
        "vs_conv_oracle": readings["vs_conv_oracle"] <= lim["vgg16_vs_conv_oracle"],
        "vs_cpu": readings["vs_cpu"] <= lim["vgg16_vs_cpu"],
        "wrong_flatten_caught": wrong["flatten_permutation_skipped"]
        > KERAS_FAULT_FACTOR * lim["vgg16_vs_conv_oracle"],
        "train_vs_cpu": within_limits(train, lim["vgg16_train"]),
        "losses_finite": bool(np.isfinite(losses32).all()),
    }
    out = dict(archive_bytes=size, archive_mb=size / 1e6, write_s=write_s, read_s=read_s,
               read_mb_per_s=size / 1e6 / read_s, import_s=import_s,
               import_mb_per_s=size / 1e6 / import_s, read_back=back, num_params=n_params,
               serve_B=VGG_SERVE_B, eager_ms_runs=eager_runs, replayed_ms_runs=replay_runs,
               eager_ms=statistics.median(eager_runs),
               replayed_ms=statistics.median(replay_runs),
               readings=readings, wrong_readings=wrong,
               limits={k: lim[k] for k in ("vgg16_vs_conv_oracle", "vgg16_vs_cpu")},
               fault_factor=KERAS_FAULT_FACTOR, train_readings=train,
               train_limits=lim["vgg16_train"], first_loss=float(first[0][0]),
               cpu_first_loss=float(ref[0][0]), train_B=VGG_TRAIN_B,
               lr=VGG_LR, update_ms_runs=update_runs,
               update_ms=statistics.median(update_runs), losses_B32=losses32, launches=launches,
               phase_s=time.perf_counter() - t_phase)
    emit("keras_vgg16", **out, checks=checks, ok=not failed(checks), gpu=card)
    if failed(checks):
        raise AssertionError(f"keras_vgg16 failed its checks: {failed(checks)}")
    del net
    gc_collect(torch)
    return launches, out


def gateway_session(server, mc, tc, batches, x_pred, y_pred, out: dict) -> None:
    """A client of ``server``: create model (a) from its JSON, fit each
    batch, predict and evaluate; each op's result and ms into ``out``."""
    from deeplearning4j_tpu_torch.interop import GatewayClient

    client = GatewayClient(server.host, server.port)
    ms = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        r = fn()
        ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return r

    try:
        out["num_params"] = timed("create", lambda: client.create_model("text", mc, tc))
        out["losses"] = [timed("fit", lambda b=b: client.fit("text", *b)) for b in batches]
        out["predict"] = timed("predict", lambda: client.predict("text", x_pred))
        out["score"] = timed("evaluate", lambda: client.evaluate("text", x_pred, y_pred))
        out["ms"] = ms
    except Exception as e:  # noqa: BLE001 - read by the phase
        out["error"] = f"{type(e).__name__}: {e}"
    finally:
        client.close()


def phase_keras_gateway(torch, W, card):
    """(c): a GatewayServer on 127.0.0.1 on the card and a client thread
    running model (a)'s JSON with an Adam training config: create, fit 4
    batches of 128, predict 128 windows, evaluate; ms per op. The same
    session against a GatewayServer on the CPU (the same seed's init):
    losses, predictions and score. Returns (launches by path, readings,
    the served model's leaf shapes)."""
    import numpy as np

    from deeplearning4j_tpu_torch import params_to_numpy
    from deeplearning4j_tpu_torch.interop import GatewayServer

    t_phase = time.perf_counter()
    lim = KERAS_LIMITS["gateway"]
    mc, _, _, _ = text_generator_archive(W, SEED + 80)
    tc = {"optimizer_config": {"class_name": "Adam", "config": dict(KERAS_ADAM)},
          "loss": "categorical_crossentropy"}
    batches = [text_windows(KERAS_B, SEED + 95 + i) for i in range(GATEWAY_FITS)]
    x_pred, y_pred = text_windows(KERAS_B, SEED + 99)
    runs, replays = {}, {}
    for device in ("cuda", "cpu"):
        with GatewayServer("127.0.0.1", 0, device=device) as server:
            got = {}

            def session():
                t = threading.Thread(target=gateway_session,
                                     args=(server, mc, tc, batches, x_pred, y_pred, got))
                t.start()
                t.join(300)
                return t.is_alive()

            if device == "cuda":
                hung, counts = counted(torch, session, replays)
                leaf_shapes = [np.shape(p[k]) for p in params_to_numpy(server._models["text"])
                               for k in p]
            else:
                hung = session()
            runs[device] = got
            if hung or "error" in got:
                raise AssertionError(f"gateway session on {device}: {got.get('error', 'hung')}")
    card_run, cpu_run = runs["cuda"], runs["cpu"]
    readings = {
        "loss_rel": float(np.max(np.abs(np.subtract(card_run["losses"], cpu_run["losses"]))
                                 / np.abs(cpu_run["losses"]))),
        "predict": logp_err(card_run["predict"],
                            np.log(np.asarray(cpu_run["predict"], np.float64))),
        "score_rel": abs(card_run["score"] - cpu_run["score"]) / abs(cpu_run["score"])}
    checks = {"vs_cpu": within_limits(readings, lim),
              "num_params": card_run["num_params"] == cpu_run["num_params"],
              "adam_8_leaves": len(leaf_shapes) == 8,
              "adam_launched": counts.get("adam_update", 0) == GATEWAY_FITS,
              "predict_shape": card_run["predict"].shape == (KERAS_B, KERAS_CHARS)}
    out = dict(fits=GATEWAY_FITS, B=KERAS_B, num_params=card_run["num_params"],
               losses=card_run["losses"], cpu_losses=cpu_run["losses"],
               score=card_run["score"], readings=readings, limits=lim,
               ms_per_op={k: statistics.median(v) for k, v in card_run["ms"].items()},
               ms_runs=card_run["ms"], cpu_ms_per_op={
                   k: statistics.median(v) for k, v in cpu_run["ms"].items()},
               launches=counts, replayed_launches=replays,
               phase_s=time.perf_counter() - t_phase)
    emit("keras_gateway", **out, checks=checks, ok=not failed(checks), gpu=card)
    if failed(checks):
        raise AssertionError(f"keras_gateway failed its checks: {failed(checks)}")
    return {"gateway": counts}, out, leaf_shapes


def phase_kernels_keras(torch, ls):
    """Rows 5-9 and dRW with the gate activation hardsigmoid (Keras's LSTM
    default) at the text generator's shape T=40, B=128, H=128, f32 and bf16,
    each against its plain version: row 5 unmasked, masked and at B=1 (the
    generation loop), its wrong products caught; rows 6-9 on every output
    and grad (``train_rows_case``), the backward's wrong products caught;
    the dRW product alone at R = T*B. The f32 checks of row 5 unmasked,
    rows 6-7 and dRW at this shape, wrong products included, are
    kernels_slice25's (``lean_at``, ``lstm_rows_at``), not repeated here."""
    T, B, H, gate = KERAS_MAXLEN, KERAS_B, KERAS_UNITS, "hardsigmoid"
    errs = phase_kernels(torch, ls, gate=gate, H=H, cases=((T, B, True), (T, 1, False)),
                         dtypes=("float32",))
    errs.update(phase_kernels(torch, ls, gate=gate, H=H, dtypes=("bfloat16",),
                              cases=((T, B, False), (T, B, True), (T, 1, False))))
    errs.update(train_rows_case(torch, ls, "float32", T, True, B=B, H=H, gate=gate))
    for masked in (False, True):
        errs.update(train_rows_case(torch, ls, "bfloat16", T, masked, B=B, H=H, gate=gate,
                                    faults=not masked))
    h0, ys, dzx = drw_inputs(torch, T, H, "bfloat16", SEED + 96, B=B)
    got, ref = ls.drw_product(h0, ys, dzx), ls.drw_product_reference(h0, ys, dzx)
    torch.cuda.synchronize()
    r = rel_readings([got], [ref], ["dRW"])["dRW"]
    ok = tuple(got.shape) == (H, 4 * H) and drw_within(r, "bfloat16")
    emit("kernel_vs_plain", kernel="drw_product", dtype="bfloat16", T=T, B=B, R=T * B, H=H,
         at="keras_import", readings=r, ok=ok)
    if not ok:
        raise AssertionError(f"drw_product bfloat16 at keras_import: {r}")
    errs[("drw_product", "bfloat16", T)] = r["max_abs"]
    return errs


def phases_slice25(torch, ls, card):
    """The keras_import phase: the gate kernels, then (a), (b) and (c),
    each path counting from 0. Returns (launches by path, readings, the
    gateway model's leaf shapes)."""
    import tempfile

    t0 = time.perf_counter()
    kernel_errs = phase_kernels_keras(torch, ls)
    W = keras_writer()
    with tempfile.TemporaryDirectory(prefix="keras_import_") as tmp:
        text_launches, text = phase_keras_text_generator(torch, W, tmp, card)
        vgg_launches, vgg = phase_keras_vgg16(torch, W, tmp, card)
    gw_launches, gw, leaf_shapes = phase_keras_gateway(torch, W, card)
    launches = {**text_launches, **vgg_launches, **gw_launches}
    readings = {"keras_text_generator": text, "keras_vgg16": vgg, "keras_gateway": gw,
                "kernel_max_abs_err": {"/".join(map(str, k)): v
                                       for k, v in kernel_errs.items()},
                "seconds": time.perf_counter() - t0}
    emit("keras_import", seconds=readings["seconds"], launches=launches, gpu=card,
         import_s=vgg["import_s"], import_mb_per_s=vgg["import_mb_per_s"],
         read_mb_per_s=vgg["read_mb_per_s"], vgg16_eager_ms=vgg["eager_ms"],
         vgg16_replayed_ms=vgg["replayed_ms"], vgg16_update_ms=vgg["update_ms"],
         generate_chars_per_s=text["chars_per_s"], gateway_ms_per_op=gw["ms_per_op"])
    return launches, readings, leaf_shapes


def kernels_slice25(torch, ls, sx, ad, card, leaf_shapes) -> dict:
    """Row 5 (masked at the served bucket T=64 with 40 live steps, and
    unmasked at T=40), rows 6-7 and dRW (gate hardsigmoid) at the text
    generator's shapes, f32, the wrong products of rows 5 and 7 caught;
    rows 10-11 at its head (N=128, C=57) and VGG16's (N=32, C=1000), row 12
    at the gateway model's 8 leaves: each against its plain version, then
    timed. Returns {(kernel, shape): (max abs err, times)}."""
    from deeplearning4j_tpu_torch.runtime.compile_manager import next_pow2

    T, B, H, gate = KERAS_MAXLEN, KERAS_B, KERAS_UNITS, "hardsigmoid"
    Ts = next_pow2(T)
    out = {}
    for b in (B, 1):
        out[("lstm_seq_lean_masked", f"T={Ts} B={b} H={H}, {T} live steps")] = lean_at(
            torch, ls, Ts, b, H, card, "keras_import", gate=gate, live=T)
    out[("lstm_seq_lean", f"T={T} B={B} H={H}")] = lean_at(
        torch, ls, T, B, H, card, "keras_import", gate=gate, faults=True)
    for k, (err, t) in lstm_rows_at(torch, ls, T, B, H, card, "keras_import", gate=gate,
                                    faults=True).items():
        out[(k, f"R={T * B} H={H}" if k == "drw_product" else f"T={T} B={B} H={H}")] = (err, t)
    for N, C, what in ((B, KERAS_CHARS, "the text generator's head"),
                       (VGG_TRAIN_B, VGG_CLASSES, "VGG16's head")):
        e = sxent_case(torch, sx, N, C, "float32", "one_hot", SEED + N + C)
        for (k, _), t in time_sxent(torch, sx, N, C, ("float32",), card, what).items():
            out[(k, f"N={N} C={C}")] = (
                e["loss"] if k.endswith("fwd") else max(e["dx"], e["dl"]), t)
    _, sc = adam_inputs(torch, SEED)
    leaves, _ = adam_inputs(torch, SEED + 97, leaf_shapes)
    out[("adam_update", f"{len(leaf_shapes)} leaves")] = (
        adam_check(torch, ad, "keras_gateway", leaves, sc),
        time_adam(torch, ad, card, leaf_shapes, f"the gateway model's {len(leaf_shapes)} leaves"))
    return out


def sum_counts(counts) -> dict:
    """Launch counts added kernel by kernel."""
    total = {}
    for c in counts:
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "deeplearning4j_tpu_torch")):
        print("chip_smoke: the port's package is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    # the phases of slices 1-20 hold the eager path, which this knob keeps;
    # slice 21's phases (4n) hold the default, replayed serving path against it
    os.environ["DL4JTPU_INFER"] = "legacy"
    import numpy as np

    from deeplearning4j_tpu_torch import (DecodeServer, MultiLayerNetwork, alexnet_conf,
                                          char_rnn, googlenet_conf, load_jax_params, ops,
                                          resnet50_conf)
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops import adam as ad
    from deeplearning4j_tpu_torch.ops import lstm_sequence as ls
    from deeplearning4j_tpu_torch.ops import softmax_xent as sx

    # the modules, which ops' functions of the same names shadow as attributes
    fa = importlib.import_module("deeplearning4j_tpu_torch.ops.flash_attention")
    lr = importlib.import_module("deeplearning4j_tpu_torch.ops.lrn")
    lc = importlib.import_module("deeplearning4j_tpu_torch.ops.lstm_cell")

    # ---- 1. environment and build
    card = gpu_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build_s = _build.build()
    emit("environment", gpu=card, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), matmul_allow_tf32=False,
         cudnn_allow_tf32=False, build_seconds=time.perf_counter() - t0,
         build_seconds_by_source=build_s)
    sass = phase_sass(build_s)

    # ---- 1b. slice 23: the training UI and its host tier (LeNet trained from
    # IDX files through the C++ loader under the dashboard's listeners,
    # served over HTTP, its features embedded by t-SNE and clustered by
    # k-means on the card) on the default, replayed path; counts from 0. It
    # runs first: the profiler's trace of its listener's window drops
    # kernels in a process that has run for minutes (a whole update's
    # forward ten minutes in, where it used to run)
    os.environ.pop("DL4JTPU_INFER")
    s23_launches, s23_readings = phase_ui_lenet(torch, card)
    os.environ["DL4JTPU_INFER"] = "legacy"

    # ---- 2. each kernel against its plain version
    errs = phase_kernels(torch, ls)
    errs.update(phase_kernels_train(torch, ls, sx))
    drw_errs = phase_kernels_drw(torch, ls)
    adam_errs = phase_adam(torch, ad)
    errs[("adam_update", "float32", "leaves")] = adam_errs["char_rnn"]
    adam_dev_errs = phase_adam_dev(torch, ad)
    errs[("adam_update_dev", "float32", "leaves")] = adam_dev_errs["char_rnn"]
    errs.update(phase_kernels_attention(torch, fa))
    errs.update(phase_kernels_lrn(torch, lr, sx))
    mnist_errs = phase_kernels_mnist(torch, sx)
    real_errs = phase_kernels_real_data(torch, sx)
    cell_errs = phase_kernels_cell(torch, lc)

    # ---- 3 + 4. the main path: serving, then decode; counts from 0
    confs = {dt: char_rnn(VOCAB, HIDDEN, LAYERS, dtype=dt)
             for dt in ("float32", "bfloat16")}
    host_params = char_rnn_params(confs["float32"], SEED)
    nets = {dt: load_jax_params(MultiLayerNetwork(c), host_params)
            for dt, c in confs.items()}
    rng = np.random.default_rng(SEED)
    x = one_hot(rng.integers(0, VOCAB, (BATCH, STEPS)), VOCAB)
    ops.reset_counters()
    served = {}
    for dt, net in nets.items():
        before = ls.launches["lstm_seq_lean"]
        probs = net.output(x)
        cls = net.predict(x)
        torch.cuda.synchronize()
        rose = ls.launches["lstm_seq_lean"] - before
        served[dt] = (probs, cls, rose)
    server = DecodeServer(nets["float32"], capacity=SLOTS, max_delay_ms=2.0)
    trajectories, decode_s = decode_sessions(server)
    ticks = server.ticks
    server.stop()
    launches = ops.counters()

    for dt, (probs, cls, rose) in served.items():
        cpu = load_jax_params(MultiLayerNetwork(confs[dt], device="cpu"), host_params)
        ref = cpu.output(x)
        err = float(np.abs(probs - ref).max())
        ok = (probs.shape == (BATCH, STEPS, VOCAB) and bool(np.isfinite(probs).all())
              and float(np.abs(probs.sum(-1) - 1.0).max()) < 1e-2
              and cls.shape == (BATCH, STEPS) and rose == 2 * LAYERS
              and err <= SERVE_ATOL[dt])
        emit("serve_output", dtype=dt, shape=list(probs.shape),
             kernel_launches=rose, expected_launches=2 * LAYERS,
             max_abs_err_vs_cpu=err, atol=SERVE_ATOL[dt],
             argmax_agree_vs_cpu=float((cls == ref.argmax(-1)).mean()), ok=ok)
        if not ok:
            raise AssertionError(f"serving {dt} failed its checks")

    alone_err, same_tokens = decode_vs_alone(nets["float32"], trajectories)
    ok = same_tokens and alone_err <= DECODE_ATOL and launches["lstm_seq_lean_masked"] > 0
    emit("decode_server", sessions=SLOTS, chars_each=DECODE_CHARS, ticks=ticks,
         seconds=decode_s, tokens_per_s=SLOTS * DECODE_CHARS / decode_s,
         same_tokens_as_alone=same_tokens, max_abs_err_vs_alone=alone_err,
         atol=DECODE_ATOL, ok=ok, gpu=card)
    if not ok:
        raise AssertionError("decode sessions differ from running alone")
    if not (launches["lstm_seq_lean"] and launches["lstm_seq_lean_masked"]):
        raise AssertionError(f"a kernel of the serving path did not launch: {launches}")

    # ---- 4a. the cell route served and decoding (row 1): counts from 0
    cell_serve = phase_serve_cell(torch, confs, host_params, x, nets["float32"], card)

    # ---- 4b. the training path: each run counts from 0 (phase_train)
    train = {}
    for mode in ("standard", "tbptt"):
        for dtype in ("float32", "bfloat16"):
            train[(mode, dtype)] = phase_train(torch, mode, dtype, host_params, card)
    for name in ("lstm_seq_train_fwd", "lstm_seq_bwd", "drw_product", "softmax_xent_fwd",
                 "softmax_xent_bwd"):
        launches[name] = sum(run[0][name] for run in train.values())
        if not launches[name]:
            raise AssertionError(f"{name} did not launch on the training path")

    # ---- 4c. the training recipe: Adam over padded batches (rows 8, 9, 12)
    recipe = {dtype: phase_train_recipe(torch, dtype, host_params, card)
              for dtype in ("float32", "bfloat16")}
    for name in ("lstm_seq_masked_train_fwd", "lstm_seq_masked_bwd", "adam_update"):
        launches[name] = sum(run[0][name] for run in recipe.values())
        if not launches[name]:
            raise AssertionError(f"{name} did not launch on the training recipe's path")
    for name in ("drw_product", "softmax_xent_fwd", "softmax_xent_bwd"):  # both paths
        launches[name] += sum(run[0][name] for run in recipe.values())

    # ---- 4c2. the cell route trained: SGD and the recipe (rows 1-2; 10-12)
    cell_train = {dtype: phase_train_cell(torch, dtype, host_params, card)
                  for dtype in ("float32", "bfloat16")}
    for name in CELL_KERNELS:
        launches[name] = (cell_serve[name]
                          + sum(run[0][name] for run in cell_train.values()))
        if not launches[name]:
            raise AssertionError(f"{name} did not launch on the cell route")
    for name in ("drw_product", "softmax_xent_fwd", "softmax_xent_bwd", "adam_update"):
        launches[name] += sum(run[0][name] for run in cell_train.values())

    # ---- 4d. the attention net: serving, then training (rows 13-15; 10-12)
    serve_launches = phase_serve_attention(torch, card)
    attn_train = {dtype: phase_train_attention(torch, dtype, card)
                  for dtype in ("float32", "bfloat16")}
    for name in ATTN_KERNELS:
        launches[name] = (serve_launches.get(name, 0)
                          + sum(run[0][name] for run in attn_train.values()))
        if not launches[name]:
            raise AssertionError(f"{name} did not launch on the attention path")
    for name in ("softmax_xent_fwd", "softmax_xent_bwd", "adam_update"):
        launches[name] += sum(run[0][name] for run in attn_train.values())

    # ---- 4e. AlexNet: serving, then training (rows 3-4; 10-11)
    alex_host = alexnet_params(alexnet_conf(), SEED)
    alex_serve = phase_serve_alexnet(torch, alex_host, card)
    alex_train = {dtype: phase_train_alexnet(torch, lr, dtype, alex_host, card)
                  for dtype in ("float32", "bfloat16")}
    for name in LRN_KERNELS:
        launches[name] = (alex_serve.get(name, 0)
                          + sum(run[0][name] for run in alex_train.values()))
        if not launches[name]:
            raise AssertionError(f"{name} did not launch on the AlexNet path")
    for name in ("softmax_xent_fwd", "softmax_xent_bwd"):
        launches[name] += sum(run[0][name] for run in alex_train.values())

    # ---- 4f. GoogLeNet, a ComputationGraph: serving, then training (rows 3-4; 10-11)
    goog_host = googlenet_params(googlenet_conf(aux_heads=True), SEED)
    goog_serve = phase_serve_googlenet(torch, goog_host, card)
    goog_train = {dtype: phase_train_googlenet(torch, lr, dtype, goog_host, card)
                  for dtype in ("float32", "bfloat16")}
    for name in (*LRN_KERNELS, "softmax_xent_fwd", "softmax_xent_bwd"):
        on_path = (goog_serve.get(name, 0)
                   + sum(run[0].get(name, 0) for run in goog_train.values()))
        if not on_path:
            raise AssertionError(f"{name} did not launch on the GoogLeNet path")
        launches[name] += on_path

    # ---- 4g. ResNet-50, a ComputationGraph with BatchNormalization: serving,
    # then training (rows 10-11); each phase counts from 0
    torch.cuda.empty_cache()
    res_host = resnet_params(resnet50_conf(), SEED)
    res_state = resnet_serving_state(res_host)
    phase_serve_resnet50(torch, res_host, res_state, card)
    res_train = {dtype: phase_train_resnet50(torch, dtype, res_host, card)
                 for dtype in ("float32", "bfloat16")}
    # ---- 4h. LeNet and the MNIST MLP on MultiLayerNetwork (rows 10-12)
    mnist_train = {name: phase_train_mnist(torch, name, card) for name in mnist_models()}
    new_path_launches = {("resnet50", k): sum(run[0].get(k, 0) for run in res_train.values())
                         for k in ("softmax_xent_fwd", "softmax_xent_bwd")}
    for name, (counts, _) in mnist_train.items():
        for k in ("softmax_xent_fwd", "softmax_xent_bwd", "adam_update"):
            new_path_launches[(name, k)] = counts.get(k, 0)
    # ---- 4i. slice 16: the accuracy pins on real data, then the char-RNN fed
    # from record files (rows 5-12); each phase counts from 0
    real_train = {name: phase_train_real(torch, name, card) for name in real_data_models()}
    real_launches = {name: run[0] for name, run in real_train.items()}
    real_launches["pangram"], _ = phase_train_pangram(torch, ls, card)
    real_launches["records"], records_mask = phase_train_records(
        torch, real_train["iris"][1], real_train["iris"][2], card)
    for where, names in REAL_DATA_ROWS.items():
        for k in names:
            new_path_launches[(where, k)] = real_launches[where].get(k, 0)
    # ---- 4j. slice 17: the staged loop, its step captured and replayed
    # (ResNet-50, the recipe on both routes, LeNet and the MLP), and the
    # prefetch of fit (AlexNet); each phase counts from 0
    staged_launches, staged_replays, staged_replayed, staged_times = phases_slice17(
        torch, card, res_host, alex_host, host_params)
    for counts in staged_launches.values():
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    replayed = {}  # what the replays launched (the counts above hold the recordings)
    for counts in staged_replayed.values():
        for k, v in counts.items():
            replayed[k] = replayed.get(k, 0) + v
    new_path_launches[("lenet", "adam_update_dev")] = staged_launches["lenet"]["adam_update_dev"]
    # ---- 4k. slice 18: the char-RNN as a ComputationGraph (TBPTT, stream,
    # decode), the sequence classifier, the MoE block; each phase counts from 0
    s18_launches, s18_times = {}, {}
    graph_runs = {dtype: phase_train_graph_char_rnn(torch, dtype, host_params, card)
                  for dtype in ("float32", "bfloat16")}
    graph_serve = phase_serve_graph_char_rnn(torch, host_params, x, nets["float32"],
                                             trajectories, card)
    s18_launches["graph_char_rnn"] = sum_counts(
        [run[0] for run in graph_runs.values()] + [graph_serve[0]])
    s18_times["graph_char_rnn"] = {**{dt: run[1] for dt, run in graph_runs.items()},
                                   "serve": graph_serve[1]}
    seq_counts, s18_times["seq_classifier"], seq_mask, seq_shapes = phase_train_seq_classifier(
        torch, card)
    s18_launches["seq_classifier"] = seq_counts
    moe_runs = {dtype: phase_train_moe_attention(torch, dtype, card)
                for dtype in ("float32", "bfloat16")}
    s18_launches["moe_attention"] = sum_counts([run[0] for run in moe_runs.values()])
    s18_times["moe_attention"] = {dt: run[1] for dt, run in moe_runs.items()}
    for counts in s18_launches.values():
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    for path, rows in SLICE18_ROWS.items():
        for k in rows:
            new_path_launches[(path, k)] = s18_launches[path].get(k, 0)
    # ---- 4l. slice 19: pretraining and transfer learning (the DBN, the
    # digits DBN, the VAE, ResNet-50 transferred, early stopping; rows
    # 10-12); each phase counts from 0
    s19_launches, s19_times, s19_shapes = phases_slice19(torch, card, res_host, res_state,
                                                         res_train["float32"][1])
    for counts in s19_launches.values():
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    for path, rows in SLICE19_ROWS.items():
        for k in rows:
            new_path_launches[(path, k)] = s19_launches[path].get(k, 0)
    # ---- 4m. slice 20: training observability and the rest of the
    # optimizers (ResNet-50 on LAMB under telemetry, the seven updaters on
    # the char-RNN, the solvers on Iris, the watchdog and flight recorder on
    # the MNIST MLP; rows 6-7, 10-12); each phase counts from 0
    s20_launches, s20_times = phases_slice20(torch, card, res_host, host_params)
    for counts in s20_launches.values():
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    for path, rows in SLICE20_ROWS.items():
        for k in rows:
            new_path_launches[(path, k)] = s20_launches[path].get(k, 0)
    # ---- 4n. slice 21: the serving front on the default path, each bucket
    # a replayed CUDA graph (GoogLeNet, ResNet-50, the char-RNN; the
    # service and its decode); each phase counts from 0
    os.environ.pop("DL4JTPU_INFER")
    s21_launches, s21_replayed, s21_readings, s21_yardstick = phases_slice21(
        torch, card, goog_host, res_host, res_state, host_params, alex_host)
    os.environ["DL4JTPU_INFER"] = "legacy"
    for counts in s21_launches.values():
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    for path, k, _ in SLICE21_ROWS:
        new_path_launches[(path, k)] = min(s21_launches[path].get(k, 0),
                                           s21_replayed[path].get(k, 0))
    # ---- 4o. slice 22: the char-RNN trained online (OnlineTrainer, the
    # CheckpointStore, hot swaps into an InferenceService under client
    # traffic, a rollback) on the default, replayed path; counts from 0
    os.environ.pop("DL4JTPU_INFER")
    s22_launches, s22_by_t, s22_readings, s22_mask = phase_online_char_rnn(
        torch, host_params, card)
    os.environ["DL4JTPU_INFER"] = "legacy"
    for k, v in s22_launches.items():
        launches[k] = launches.get(k, 0) + v
    # ---- 4p. slice 23's launches (its phase ran first, in section 1b)
    for k, v in s23_launches.items():
        launches[k] = launches.get(k, 0) + v
    for k in SLICE23_ROWS:
        new_path_launches[("ui_lenet", k)] = s23_launches.get(k, 0)
    # ---- 4q. slice 24: the NLP stack and graph embeddings (Word2Vec at 300
    # dimensions, ParagraphVectors, GloVe, DistributedWord2Vec, DeepWalk at
    # BlogCatalog's size; their embedding steps plain tensor ops), then the
    # vectors into the sentiment LSTM (rows 8-12) on the default path;
    # counts from 0
    os.environ.pop("DL4JTPU_INFER")
    s24_launches, s24_mask, s24_shapes, s24_readings = phases_slice24(torch, card)
    os.environ["DL4JTPU_INFER"] = "legacy"
    for k, v in s24_launches.items():
        launches[k] = launches.get(k, 0) + v
    for k in SLICE24_ROWS:
        new_path_launches[("w2v_sentiment", k)] = s24_launches.get(k, 0)
    # ---- 4r. slice 25: Keras model import and the Keras gateway (the text
    # generator and VGG16 read from HDF5 without h5py, served, generated
    # and fine-tuned; the gateway's session; rows 5-7, dRW and 10-12 with
    # the hardsigmoid gate) on the default path; each path counts from 0
    os.environ.pop("DL4JTPU_INFER")
    s25_launches, s25_readings, s25_shapes = phases_slice25(torch, ls, card)
    os.environ["DL4JTPU_INFER"] = "legacy"
    for counts in s25_launches.values():
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    for (k, shape), paths in SLICE25_ROWS.items():
        new_path_launches[("keras_import", k, shape)] = sum(
            s25_launches[p].get(k, 0) for p in paths)
    missing = [key for key, n in new_path_launches.items() if not n]
    if missing:
        raise AssertionError(f"kernels that did not launch on their path: {missing}")

    # ---- 5. times
    times = {}
    for dtype in ("float32", "bfloat16"):
        for T, B, masked in ((STEPS, BATCH, False), (1, SLOTS, True)):
            args = seq_inputs(torch, T, B, HIDDEN, dtype, masked, SEED)
            if masked:
                kern = lambda: ls.fused_lstm_sequence_masked(*args)  # noqa: E731
                plain = lambda: ls.lstm_sequence_masked_reference(*args)  # noqa: E731
            else:
                kern = lambda: ls.fused_lstm_sequence(*args)  # noqa: E731
                plain = lambda: ls.lstm_sequence_reference(*args)  # noqa: E731
            plain_ms_1 = median_ms(plain, **PLAIN_REPS)
            ms_1 = median_ms(kern)
            ms_2 = median_ms(kern)
            plain_ms_2 = median_ms(plain, **PLAIN_REPS)
            b_ms, b_by = bound(T, B, HIDDEN, dtype, masked,
                               live_share(args[1]) if masked else 1.0)
            name = "lstm_seq_lean_masked" if masked else "lstm_seq_lean"
            times[(name, dtype)] = dict(
                ms=min(ms_1, ms_2), plain_ms=min(plain_ms_1, plain_ms_2),
                bound_ms=b_ms, bound_by=b_by, T=T, B=B)
            emit("time_kernel", kernel=name, dtype=dtype, T=T, B=B, H=HIDDEN,
                 ms_runs=[ms_1, ms_2], plain_ms_runs=[plain_ms_1, plain_ms_2],
                 bound_ms=b_ms, bound_by=b_by, step_launches=T,
                 library_ms=None, gpu=card)
    for dt, net in nets.items():
        net.output(x)
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            net.output(x)
            runs.append((time.perf_counter() - t0) * 1e3)
        emit("time_output", dtype=dt, B=BATCH, T=STEPS, ms_median=statistics.median(runs),
             ms_runs=runs, gpu=card)

    times.update(time_train_kernels(torch, ls, sx, card))
    cell_times = time_cell(torch, lc, times, card)
    drw_times = time_drw(torch, ls, card)
    times[("drw_product", "float32")] = drw_times[("float32", STEPS * BATCH)]
    for name in CELL_KERNELS:  # the table's shape: B=64
        times[(name, "float32")] = cell_times[(name, "float32", BATCH)]
    emit("recipe_update_by_route", gpu=card, **{
        dtype: {"fusedcell_ms_per_update": cell_train[dtype][1]["fusedcell"],
                "seqfused_ms_per_update_same_phase": cell_train[dtype][1]["seqfused"],
                "seqfused_ms_per_update_train_recipe": recipe[dtype][1]}
        for dtype in cell_train})
    times[("adam_update", "float32")] = time_adam(torch, ad, card)
    times[("adam_update_dev", "float32")] = time_adam(torch, ad, card, dev=True)
    times.update(time_attention(torch, fa, card))
    lrn_times = time_lrn(torch, lr, card, sass["lrn"])
    for name in LRN_KERNELS:  # the table's shape: LRN 1
        times[(name, "float32")] = lrn_times[(name, "float32", "lrn1")]
    head_times = time_sxent_head(torch, sx, card)
    for name, (B, conf) in mnist_models().items():
        for (k, _), t in time_sxent(torch, sx, B, 10, ("float32",), card,
                                    f"{name}'s loss head").items():
            times[(k, name)] = t
        shapes = mnist_leaf_shapes(conf)
        times[("adam_update", name)] = time_adam(torch, ad, card, shapes,
                                                 f"{name}'s {len(shapes)} leaves")
        if name == "lenet":
            times[("adam_update_dev", name)] = time_adam(
                torch, ad, card, shapes, f"{name}'s {len(shapes)} leaves", dev=True)
    real_shapes = real_data_adam_shapes()
    for where, (N, C) in REAL_DATA_SXENT.items():
        for (k, _), t in time_sxent(torch, sx, N, C, ("float32",), card,
                                    f"{where}'s loss head").items():
            times[(k, where)] = t
        times[("adam_update", where)] = time_adam(torch, ad, card, real_shapes[where],
                                                  f"{where}'s {len(real_shapes[where])} leaves")
    lstm_at = {"pangram": lstm_rows_at(torch, ls, PANGRAM_TBPTT, PANGRAM_B, PANGRAM_H, card,
                                       "pangram"),
               "records": lstm_rows_at(torch, ls, records_mask.shape[0], RECORDS_B, HIDDEN,
                                       card, "records", mask=records_mask)}
    lstm_at["pangram"]["lstm_seq_lean"] = list(lean_at(torch, ls, PANGRAM_T, PANGRAM_B,
                                                       PANGRAM_H, card, "pangram"))
    lstm_shapes = {"pangram": {"lstm_seq_lean": (PANGRAM_T, PANGRAM_B, PANGRAM_H)},
                   "records": {}}
    s18_rows = kernels_slice18(torch, ls, sx, ad, card, seq_mask,
                               {"seq_classifier": seq_shapes,
                                "moe_attention": moe_runs["float32"][2]})
    s19_rows = kernels_slice19(torch, sx, ad, card, s19_shapes)
    s20_rows = kernels_slice20(torch, sx, card)
    s21_rows = kernels_slice21(torch, ls, lr, card)
    s22_rows = kernels_slice22(torch, ls, sx, card, s22_mask)
    s24_rows = kernels_slice24(torch, ls, sx, ad, card, s24_mask, s24_shapes)
    s25_rows = kernels_slice25(torch, ls, sx, ad, card, s25_shapes)
    emit("recipe_update_share", gpu=card, **{
        dtype: {"ms_per_update": run[1], "adam_ms_per_update": times[("adam_update", "float32")]["ms"],
                "adam_share": times[("adam_update", "float32")]["ms"] / run[1]}
        for dtype, run in recipe.items()})

    net = nets["float32"]
    emit("profile", what="output() f32 B=64 T=256", gpu=card,
         **profile(torch, lambda: net.output(x), groups=LSTM_PROFILE_GROUPS))
    _, _, train_net, (tx, ty) = train[("standard", "float32")]
    emit("profile", what="fit() one standard SGD update, f32 B=64 T=256", gpu=card,
         **profile(torch, lambda: train_net.fit((tx, ty)), groups=LSTM_PROFILE_GROUPS))
    _, _, recipe_net, recipe_it = recipe["float32"]
    long_batch = next(ds for ds in recipe_it if ds.features.shape[1] == STEPS)
    emit("profile", what="fit() one bucketed Adam TBPTT batch, f32 B=64 T=256 (6 updates)",
         gpu=card, **profile(torch, lambda: recipe_net.fit(long_batch),
                             groups=LSTM_PROFILE_GROUPS))
    _, _, cell_net, (cx, cy) = cell_train["float32"]
    emit("profile", what="fit() one standard SGD update on the fusedcell route, f32 B=64 "
         "T=256 (512 launches of each cell row)", gpu=card,
         **profile(torch, lambda: cell_net.fit((cx, cy)), top=8, groups=LSTM_PROFILE_GROUPS))
    _, _, attn_net, attn_it = attn_train["float32"]
    attn_batch = next(ds for ds in attn_it if ds.features.shape[1] == ATTN_T)
    emit("profile", what="fit() one Adam update of the attention net, f32 B=4 T=4096",
         gpu=card, **profile(torch, lambda: attn_net.fit(attn_batch)))
    _, _, alex_net, alex_batch = alex_train["float32"]
    emit("profile", what="fit() one Nesterov update of AlexNet, f32 B=128, dropout 0.5",
         gpu=card, **profile(torch, lambda: alex_net.fit(alex_batch), top=14,
                             groups=ALEX_PROFILE_GROUPS))
    for dtype, (_, _, goog_net, goog_batch) in goog_train.items():
        emit("profile", what=f"fit() one Nesterov update of GoogLeNet, {dtype} B=128, "
             "dropout 0.4", gpu=card, **profile(torch, lambda: goog_net.fit(goog_batch),
                                               top=14, groups=ALEX_PROFILE_GROUPS))
    x_goog = alexnet_images(GOOG_B, SEED + 8)[0]
    goog_serving = googlenet_net(googlenet_conf(), goog_host)
    emit("profile", what="output() of GoogLeNet, f32 B=128", gpu=card,
         **profile(torch, lambda: goog_serving.output(x_goog), top=14,
                   groups=ALEX_PROFILE_GROUPS))
    server = DecodeServer(net, capacity=SLOTS, max_delay_ms=2.0)

    emit("profile", what=f"decode {SLOTS} sessions x {DECODE_CHARS} chars f32", gpu=card,
         **profile(torch, lambda: decode_sessions(server)))
    server.stop()

    # ---- 6. the kernels of the paths (f32, at the main path's shapes)
    lines = []
    shapes = {"lstm_seq_lean": ("lstm_seq_lean", "float32", STEPS, BATCH),
              "lstm_seq_lean_masked": ("lstm_seq_lean_masked", "float32", 1, SLOTS),
              "lstm_seq_train_fwd": ("lstm_seq_train_fwd", "float32", STEPS),
              "lstm_seq_bwd": ("lstm_seq_bwd", "float32", STEPS),
              "softmax_xent_fwd": ("softmax_xent_fwd", "float32", SXENT_ROWS[0]),
              "softmax_xent_bwd": ("softmax_xent_bwd", "float32", SXENT_ROWS[0]),
              "lstm_seq_masked_train_fwd": ("lstm_seq_masked_train_fwd", "float32", STEPS),
              "lstm_seq_masked_bwd": ("lstm_seq_masked_bwd", "float32", STEPS),
              "adam_update": ("adam_update", "float32", "leaves"),
              "adam_update_dev": ("adam_update_dev", "float32", "leaves")}
    for name in ATTN_KERNELS:  # the main shape, with and without the key mask
        shapes[name] = (name, "float32")
        errs[shapes[name]] = max(errs[(name, "float32", m)] for m in (False, True))
    for name in LRN_KERNELS:  # LRN 1's shape
        shapes[name] = (name, "float32")
    for name in CELL_KERNELS:  # B=64, H=512
        shapes[name] = (name, "float32")
        errs[shapes[name]] = cell_errs[name]
    shapes["drw_product"] = ("drw_product", "float32")  # R=16384, H=512
    errs[shapes["drw_product"]] = drw_errs["float32"]
    for name, (source, replaces) in {**KERNELS, **ATTN_KERNELS, **LRN_KERNELS,
                                     **CELL_KERNELS, **DRW_KERNELS}.items():
        t = times[(name, "float32")]
        lines.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[shapes[name]],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t.get("library_ms"),
            "dtype": "float32", "kernel_device_ms": t.get("kernel_device_ms")})
    # rows 10-12 at the shapes of slice 15's paths
    for model, shape in (("resnet50", f"N={ALEX_SXENT[0]} C={ALEX_SXENT[1]}"),
                         *((m, f"N={B} C=10") for m, (B, _) in mnist_models().items())):
        for k in ("softmax_xent_fwd", "softmax_xent_bwd"):
            t = (head_times[(k, "float32")] if model == "resnet50" else times[(k, model)])
            e = errs[("sxent_head", "float32")] if model == "resnet50" else mnist_errs[model]
            lines.append({
                "name": f"{k}@{model}", "route": "cuda", "source": KERNELS[k][0],
                "replaces": KERNELS[k][1], "launches": new_path_launches[(model, k)],
                "max_abs_err": e["loss"] if k.endswith("fwd") else max(e["dx"], e["dl"]),
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"], "dtype": "float32",
                "shape": shape, "kernel_device_ms": None})
        if model != "resnet50":
            t = times[("adam_update", model)]
            lines.append({
                "name": f"adam_update@{model}", "route": "cuda",
                "source": KERNELS["adam_update"][0], "replaces": KERNELS["adam_update"][1],
                "launches": new_path_launches[(model, "adam_update")],
                "max_abs_err": adam_errs[model], "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"], "dtype": "float32",
                "shape": f"{len(mnist_leaf_shapes(mnist_models()[model][1]))} leaves",
                "kernel_device_ms": t.get("kernel_device_ms")})
    # row 12's device-scalar entry at LeNet's leaves (slice 17's staged LeNet)
    t = times[("adam_update_dev", "lenet")]
    lines.append({
        "name": "adam_update_dev@lenet", "route": "cuda", "source": KERNELS["adam_update_dev"][0],
        "replaces": KERNELS["adam_update_dev"][1],
        "launches": new_path_launches[("lenet", "adam_update_dev")],
        "max_abs_err": adam_dev_errs["lenet"], "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "dtype": "float32", "shape": f"{len(mnist_leaf_shapes(mnist_models()['lenet'][1]))} leaves",
        "kernel_device_ms": t.get("kernel_device_ms")})
    # rows 5-12 at the shapes of slice 16's paths
    seg_T = {"pangram": PANGRAM_TBPTT, "records": int(records_mask.shape[0])}
    seg_B = {"pangram": PANGRAM_B, "records": RECORDS_B}
    seg_H = {"pangram": PANGRAM_H, "records": HIDDEN}
    for where, names in REAL_DATA_ROWS.items():
        for k in names:
            if k.startswith("softmax_xent"):
                e, t = real_errs[where], times[(k, where)]
                err = e["loss"] if k.endswith("fwd") else max(e["dx"], e["dl"])
                shape = "N={} C={}".format(*REAL_DATA_SXENT[where])
            elif k == "adam_update":
                err, t = adam_errs[where], times[(k, where)]
                shape = f"{len(real_shapes[where])} leaves"
            else:
                err, t = lstm_at[where][k]
                T, B, H = lstm_shapes[where].get(k, (seg_T[where], seg_B[where], seg_H[where]))
                shape = f"T={T} B={B} H={H}" + (
                    f" R={T * B}" if k == "drw_product" else "") + (
                    ", the iterator's mask" if where == "records" and k != "drw_product" else "")
            source, replaces = {**KERNELS, **DRW_KERNELS}[k]
            lines.append({
                "name": f"{k}@{where}", "route": "cuda", "source": source,
                "replaces": replaces, "launches": new_path_launches[(where, k)],
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t.get("library_ms"), "dtype": "float32", "shape": shape,
                "kernel_device_ms": t.get("kernel_device_ms")})
    # rows 5-15 at the shapes of slice 18's paths
    main_lines = {line["name"]: line for line in lines}
    for path, rows in SLICE18_ROWS.items():
        for k, main in rows.items():
            if main is not None:
                line = dict(main_lines[main], shape=f"the main path's ({main})")
            else:
                err, t, shape = s18_rows[(path, k)]
                source, replaces = {**KERNELS, **DRW_KERNELS}[k]
                line = {"route": "cuda", "source": source, "replaces": replaces,
                        "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t.get("library_ms"), "dtype": "float32", "shape": shape,
                        "kernel_device_ms": t.get("kernel_device_ms")}
            line.update(name=f"{k}@{path}", launches=new_path_launches[(path, k)])
            lines.append(line)
    # rows 10-12 at the shapes of slice 19's paths
    main_lines = {line["name"]: line for line in lines}
    for path, rows in SLICE19_ROWS.items():
        for k, main in rows.items():
            if main is not None:
                line = dict(main_lines[main], shape=f"{main}'s (N=128 C=10)")
            else:
                err, t, shape = s19_rows[(path, k)]
                source, replaces = KERNELS[k]
                line = {"route": "cuda", "source": source, "replaces": replaces,
                        "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t.get("library_ms"), "dtype": "float32", "shape": shape,
                        "kernel_device_ms": t.get("kernel_device_ms")}
            line.update(name=f"{k}@{path}", launches=new_path_launches[(path, k)])
            lines.append(line)
    # rows 6-7, 10-12 at the shapes of slice 20's paths
    main_lines = {line["name"]: line for line in lines}
    for path, rows in SLICE20_ROWS.items():
        for k, main in rows.items():
            if main is not None:
                line = dict(main_lines[main], shape=f"{main}'s ({main_lines[main]['shape']})")
            else:
                err, t, shape = s20_rows[(path, k)]
                source, replaces = KERNELS[k]
                line = {"route": "cuda", "source": source, "replaces": replaces,
                        "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t.get("library_ms"), "dtype": "float32", "shape": shape,
                        "kernel_device_ms": t.get("kernel_device_ms")}
            line.update(name=f"{k}@{path}", launches=new_path_launches[(path, k)])
            lines.append(line)
    # beside each row's launches (which count a captured step's warm-up
    # steps and capture), the launches that the replays of slice 17's
    # captured steps made (LeNet's alone for its own row)
    for line in lines:
        name = line["name"]
        line["replayed_launches"] = (
            staged_replayed["lenet"].get("adam_update_dev", 0) if name == "adam_update_dev@lenet"
            else 0 if "@" in name else replayed.get(name, 0))
    # rows 1, 3, 5 and 13 at slice 21's shapes, counted in the served calls
    # of the path's phase alone (Windows): launches by their wrappers
    # (warm-up runs and captures of the buckets), beside them what the
    # graphs launched by replay (captured launches x replays, the kernel's
    # over all of the path's shapes), and apart the eager yardstick's
    main_lines = {line["name"]: line for line in lines}
    for (path, k, shape_name), main in SLICE21_ROWS.items():
        if main is not None:
            line = dict(main_lines[main], shape=f"{main}'s ({shape_name})")
        else:
            err, t, shape = s21_rows[(path, k, shape_name)]
            source, replaces = {**KERNELS, **LRN_KERNELS}[k]
            line = {"route": "cuda", "source": source, "replaces": replaces,
                    "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                    "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                    "library_ms": t.get("library_ms"), "dtype": "float32", "shape": shape,
                    "kernel_device_ms": t.get("kernel_device_ms")}
        line.update(name=f"{k}@{path}[{shape_name}]", launches=s21_launches[path].get(k, 0),
                    replayed_launches=s21_replayed[path].get(k, 0),
                    yardstick_launches=s21_yardstick[path].get(k, 0))
        lines.append(line)
    # rows 5 and 8-12 at the online path's shapes: launches by the path's
    # replays in that time bucket (the lean row: every served replay and the
    # eager launches of the replay's no-update loss; row 12: both buckets),
    # beside what the wrappers counted (captures and eager runs)
    main_lines = {line["name"]: line for line in lines}
    for (k, shape_name), main in SLICE22_ROWS.items():
        if main is not None:
            line = dict(main_lines[main], shape=f"{main}'s ({shape_name})")
        else:
            err, t, shape = s22_rows[(k, shape_name)]
            source, replaces = {**KERNELS, **DRW_KERNELS}[k]
            line = {"route": "cuda", "source": source, "replaces": replaces,
                    "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                    "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                    "library_ms": t.get("library_ms"), "dtype": "float32", "shape": shape,
                    "kernel_device_ms": t.get("kernel_device_ms")}
        bucket = 128 if "T=128" in shape_name else 256 if "T=256" in shape_name else None
        n = (s22_launches[k] if k in ("lstm_seq_lean", "adam_update_dev")
             else s22_by_t.get(bucket, {}).get(k, 0))
        line.update(name=f"{k}@online_char_rnn[{shape_name}]", launches=n,
                    replayed_launches=n,
                    wrapper_launches=s22_readings["wrapper_counts"].get(k, 0))
        if not n:
            raise AssertionError(f"{k} did not launch on the online path at {shape_name}")
        lines.append(line)
    # rows 10-12 at the UI path's shapes (LeNet's, so the lenet rows' times of
    # this run): launches of its training run, and of the traced window
    main_lines = {line["name"]: line for line in lines}
    for k, (shape_name, main) in SLICE23_ROWS.items():
        line = dict(main_lines[main], shape=f"{main}'s ({shape_name})")
        line.update(name=f"{k}@ui_lenet[{shape_name}]",
                    launches=new_path_launches[("ui_lenet", k)],
                    traced_launches=s23_readings["trace"]["launches"][k])
        lines.append(line)
    # rows 8-12 at the sentiment LSTM's shapes: launches of its training run
    for k in SLICE24_ROWS:
        err, t, shape = s24_rows[k]
        source, replaces = {**KERNELS, **DRW_KERNELS}[k]
        lines.append({
            "name": f"{k}@w2v_sentiment", "route": "cuda", "source": source,
            "replaces": replaces, "launches": new_path_launches[("w2v_sentiment", k)],
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms"), "dtype": "float32", "shape": shape,
            "kernel_device_ms": t.get("kernel_device_ms")})
    # rows 5-7, dRW (gate hardsigmoid) and 10-12 at the Keras import's shapes:
    # launches of the paths that run them (SLICE25_ROWS)
    for (k, shape), paths in SLICE25_ROWS.items():
        err, t = s25_rows[(k, shape)]
        source, replaces = {**KERNELS, **DRW_KERNELS}[k]
        lines.append({
            "name": f"{k}@keras_import[{shape}]", "route": "cuda", "source": source,
            "replaces": replaces, "launches": new_path_launches[("keras_import", k, shape)],
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms"), "dtype": "float32",
            "shape": shape + (", gate hardsigmoid" if k.startswith("lstm") else ""),
            "paths": list(paths), "kernel_device_ms": t.get("kernel_device_ms")})
    print(json.dumps({"kernels": lines, "launches": launches,
                      "staged_replays": staged_replays, "staged_ms_per_update": staged_times,
                      "staged_replayed_launches": staged_replayed,
                      "launches_note": "the staged paths' launches count the warm-up steps "
                      "and the capture of each captured step, where the kernel's wrapper "
                      "runs; a replay launches the recorded kernels without it, so "
                      "replayed_launches counts each graph's launches a replay times its "
                      "replays (staged_replays: the replays by path); the rows of slice 21's "
                      "paths (name@path[shape]) count the served calls of the path alone, "
                      "with every count set to 0 before each and read after it, and give "
                      "the eager yardstick's launches apart (yardstick_launches)",
                      "library_ms_note": "no single PyTorch call computes the "
                      "peephole LSTM (torch.nn.LSTM has no peepholes), masked or not; "
                      "rows 10-11: cross_entropy with probability targets, forward and "
                      "forward+backward; row 12: torch.optim.Adam(fused=True).step() "
                      "over the same 14 leaves, which also adds u to the params; rows "
                      "13-15: scaled_dot_product_attention(is_causal=True), forward for "
                      "row 13 and forward+backward (more work than either backward "
                      "kernel) for rows 14-15; rows 3-4: F.local_response_norm on the "
                      "same channels-last view (alpha times n), forward for row 3 and "
                      "forward+backward for row 4, at LRN 1's shape [128, 56, 56, 96]; "
                      "rows 1-2: none (torch.nn.LSTMCell has no peepholes); "
                      "drw_product: torch.matmul(hp.t(), dz) over the same T*B rows "
                      "stacked contiguous, f32 without TF32",
                      "adam_update_ms_covers": "the 14 leaves of one update",
                      "kernel_device_ms_note": "rows 10-12 and drw_product: the kernel's own "
                      "time on the card a call, from the profiler (null where not measured)",
                      "slice18_ms": s18_times,
                      "slice19_ms": s19_times,
                      "slice20": s20_times,
                      "slice21": {
                          "seconds": s21_readings["seconds"],
                          **{f"{path}_ms": {
                              w: {"eager": r["eager_ms"], "replayed": r["replayed_ms"],
                                  "replay_alone": r["replay_alone_ms"],
                                  "captures": r["captures"],
                                  "capture_seconds": r["capture_seconds"]}
                              for w, r in s21_readings[path].items()}
                             for path in ("serve_graphs", "serve_models")},
                          "serve_service": s21_readings["serve_service"]},
                      "slice22": {k: v for k, v in s22_readings.items()
                                  if k not in ("window_ms", "snapshot_ms", "write_s",
                                               "swap_ms")},
                      "slice23": s23_readings,
                      "slice24": s24_readings,
                      "slice25": s25_readings,
                      "script_seconds": time.perf_counter() - STARTED}),
          flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
