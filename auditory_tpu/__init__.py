"""auditory-tpu: a JAX/XLA auditory & speech
pre-processing framework with the capabilities of ``emer/auditory``.

Pipeline: WAV -> float signal -> overlapping windows -> DFT power spectrum ->
mel filterbank (log) -> optional MFCC (DCT + energy + deltas) -> 2-D gabor
convolution -> optional neighborhood inhibition + FFFB kWTA sparsification.

Everything numeric runs as one jitted tensor program, batched over segments
(and utterances, see :mod:`auditory_tpu.pipeline.batch`) and shardable over a
device mesh (see :mod:`auditory_tpu.parallel`).
"""

from .config import (
    DFTParams,
    FilterBank,
    GaborSet,
    GaborSpec,
    KWTAParams,
    MelParams,
    NeighInhibParams,
    SndEnvConfig,
    WindowParams,
    default_gabor_specs,
    msec_to_samples,
    samples_to_msec,
)
from .pipeline.batch import BatchedSndEnv, CorpusRunner
from .pipeline.dataset import FeatureDataset
from .pipeline.online import BufferOverflow, MultiStreamOnline, OnlineSndEnv
from .pipeline.segments import SegmentPipeline, SegmentWindowParams
from .pipeline.sndenv import SndEnv, SndEnvOutputs
from .pipeline.streaming import StreamingProcessor

__version__ = "0.5.0"

__all__ = [
    "BatchedSndEnv",
    "BufferOverflow",
    "MultiStreamOnline",
    "OnlineSndEnv",
    "CorpusRunner",
    "FeatureDataset",
    "SegmentPipeline",
    "SegmentWindowParams",
    "StreamingProcessor",
    "DFTParams",
    "FilterBank",
    "GaborSet",
    "GaborSpec",
    "KWTAParams",
    "MelParams",
    "NeighInhibParams",
    "SndEnv",
    "SndEnvOutputs",
    "SndEnvConfig",
    "WindowParams",
    "default_gabor_specs",
    "msec_to_samples",
    "samples_to_msec",
]
