"""The system under test's inputs: nets handed to the port as its
configuration type, and the train CLI's flags of a geometry."""

from __future__ import annotations


def port_config(geom: dict, net: dict, threshold: float):
    """The port's ``SyllableDetectorConfig`` of a geometry and a net drawn
    by :func:`benchmark.synth.net`, with ``threshold``."""
    from syllable_detector_tpu_torch.config.model_format import (
        LayerSpec,
        ProcessingSpec,
        SyllableDetectorConfig,
    )

    layers = [LayerSpec(inputs=w.shape[1], outputs=w.shape[0], weights=w, biases=b,
                        transfer=tr) for w, b, tr in net["layers"]]
    cfg = SyllableDetectorConfig(
        sampling_rate=float(geom["sampling_rate"]),
        fourier_length=geom["fourier_length"],
        window_length=geom["window_length"],
        window_overlap=geom["window_overlap"],
        freq_range=tuple(float(f) for f in geom["freq_range"]),
        time_range=geom["time_range"],
        thresholds=[float(threshold)],
        scaling=geom["scaling"],
        layers=layers,
        process_inputs=[
            ProcessingSpec("l2normalize"),
            ProcessingSpec("mapminmax", x_offsets=net["x_offsets"], gains=net["gains"],
                           y_offset=-1.0),
        ],
        process_outputs=[ProcessingSpec("mapminmax", x_offsets=[0.0], gains=[2.0],
                                        y_offset=-1.0)],
    )
    cfg.validate()
    return cfg


def geometry_flags(geom: dict) -> list[str]:
    """The train CLI's flags that give a net of ``geom``."""
    lo, hi = geom["freq_range"]
    return ["--fft", str(geom["fourier_length"]), "--window", str(geom["window_length"]),
            "--overlap", str(geom["window_overlap"]), "--freq", repr(float(lo)),
            repr(float(hi)), "--time-range", str(geom["time_range"]),
            "--scaling", geom["scaling"], "--hidden", *map(str, geom["hidden"])]

