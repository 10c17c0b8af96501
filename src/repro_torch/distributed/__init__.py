# Step-time monitoring (straggler detection).
