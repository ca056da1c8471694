"""The general generators a traffic mix names in its `driver` key: each
reads the mix's parameters, makes the inputs from the seed, runs the
window and checks what it produced (`run(ctx) -> RunResult`)."""
