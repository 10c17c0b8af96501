# Distributed training pieces: int8 compressed all-reduce, the pipeline,
# step-time monitoring (straggler detection).
