"""Codec registry — every compressor constructible by name, with capability
flags replacing scattered ``variant16`` / isinstance checks.

The registry is the single answer to "what can codec X do?": the stores and
the Encoder/Decoder ask ``device_decodable`` before routing work at the
CUDA kernels (every other codec runs on the host, and neither side falls
back to the other), a benchmark asks ``trainable`` before timing a training
phase, and the persistence layer asks ``token_stream`` before slicing
corpora on string boundaries. Capability flags are *static per codec* (they describe the
format, not one trained instance), which is what makes them safe to consult
on a host that has only the artifact, not the trainer.

Canonical names: ``onpair``, ``onpair16``, ``bpe``, ``fsst``, ``lz-block``,
``raw`` (paper Table 3 rows), plus ``zstd-block`` when the optional
``zstandard`` package is present. ``zlib-block`` remains an alias of
``lz-block`` for pre-v2 callers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.core.artifact import DictArtifact


@dataclass(frozen=True)
class CodecCaps:
    """What a codec's *format* supports (per codec, not per instance)."""

    #: payload is a stream of 2-byte token IDs; per-string slices are token
    #: streams, so corpora can be re-sliced on string boundaries and decoded
    #: through PackedDictionary / the device kernels.
    token_stream: bool = False
    #: every dictionary entry is <= 16 bytes (the OnPair16 §3.2.2 bound that
    #: enables the fixed-size-copy decode layout).
    bounded_entries: bool = False
    #: decodable by the device kernels (requires token_stream + the
    #: 16-byte-row layout).
    device_decodable: bool = False
    #: train() builds a real dictionary/table (vs a no-op for raw/block).
    trainable: bool = False


@dataclass(frozen=True)
class CodecSpec:
    name: str
    caps: CodecCaps
    #: () or (**cfg) -> untrained codec object (StringCompressor API).
    factory: Callable[..., Any]
    #: DictArtifact -> ready-to-use codec object (no training).
    from_artifact: Callable[[DictArtifact], Any]
    aliases: tuple[str, ...] = ()
    #: False when a runtime dep is missing (spec stays listed, create raises).
    available: bool = True
    unavailable_reason: str = ""


_REGISTRY: dict[str, CodecSpec] = {}
_ALIASES: dict[str, str] = {}


def register(spec: CodecSpec) -> CodecSpec:
    _REGISTRY[spec.name] = spec
    for alias in spec.aliases:
        _ALIASES[alias] = spec.name
    return spec


def resolve(name: str) -> str:
    """Canonical codec name (follows aliases); raises KeyError if unknown."""
    name = _ALIASES.get(name, name)
    if name not in _REGISTRY:
        known = ", ".join(sorted(_REGISTRY))
        raise KeyError(f"unknown codec {name!r} (registered: {known})")
    return name


def get_spec(name: str) -> CodecSpec:
    return _REGISTRY[resolve(name)]


def names(include_unavailable: bool = False) -> list[str]:
    return [n for n, s in _REGISTRY.items()
            if include_unavailable or s.available]


def capabilities(name: str) -> CodecCaps:
    return get_spec(name).caps


def create(name: str, **cfg) -> Any:
    """Construct an (untrained) codec by registry name."""
    spec = get_spec(name)
    if not spec.available:
        raise RuntimeError(f"codec {spec.name!r} unavailable: "
                           f"{spec.unavailable_reason}")
    return spec.factory(**cfg)


def train(name: str, strings: list[bytes], dataset_bytes: int | None = None,
          **cfg) -> DictArtifact:
    """Train-once entry point: build codec ``name``, train on ``strings``,
    return the immutable artifact (the only thing worth persisting)."""
    codec = create(name, **cfg)
    codec.train(strings, dataset_bytes)
    return codec.to_artifact()


def codec_from_artifact(artifact: DictArtifact) -> Any:
    """Reconstruct a ready-to-use codec from an artifact — no retraining."""
    return get_spec(artifact.codec).from_artifact(artifact)


# ----------------------------------------------------------- registrations
def _register_builtin() -> None:
    from repro_torch.core.api import RawCompressor
    from repro_torch.core.blockcomp import ZlibBlockCompressor, ZstdBlockCompressor
    from repro_torch.core.bpe import BPECompressor
    from repro_torch.core.fsst import FSSTCompressor
    from repro_torch.core.onpair import make_onpair, make_onpair16, OnPairCompressor

    register(CodecSpec(
        name="raw",
        caps=CodecCaps(),
        factory=RawCompressor,
        from_artifact=RawCompressor.from_artifact))
    register(CodecSpec(
        name="onpair",
        caps=CodecCaps(token_stream=True, trainable=True),
        factory=make_onpair,
        from_artifact=OnPairCompressor.from_artifact))
    register(CodecSpec(
        name="onpair16",
        caps=CodecCaps(token_stream=True, bounded_entries=True,
                       device_decodable=True, trainable=True),
        factory=make_onpair16,
        from_artifact=OnPairCompressor.from_artifact))
    register(CodecSpec(
        name="bpe",
        caps=CodecCaps(token_stream=True, trainable=True),
        factory=BPECompressor,
        from_artifact=BPECompressor.from_artifact))
    register(CodecSpec(
        name="fsst",
        caps=CodecCaps(bounded_entries=True, trainable=True),
        factory=FSSTCompressor,
        from_artifact=FSSTCompressor.from_artifact))
    register(CodecSpec(
        name="lz-block",
        caps=CodecCaps(),
        factory=ZlibBlockCompressor,
        from_artifact=ZlibBlockCompressor.from_artifact,
        aliases=("zlib-block",)))
    try:
        import zstandard  # noqa: F401
        zstd_ok, why = True, ""
    except ImportError:
        zstd_ok, why = False, "zstandard not installed"
    register(CodecSpec(
        name="zstd-block",
        caps=CodecCaps(),
        factory=ZstdBlockCompressor,
        from_artifact=ZstdBlockCompressor.from_artifact,
        available=zstd_ok, unavailable_reason=why))


_register_builtin()
