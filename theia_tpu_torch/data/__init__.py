"""The port's input pipeline: webdataset tar shards, the frame-level mix and its batched loader."""
