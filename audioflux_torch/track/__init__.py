from audioflux_torch.track.tune_track import TuneTrack  # noqa: F401
