"""The benchmark's plain reference: the arithmetic the program's sized
rates, forecasts, EKF observations and policy-sweep worlds must agree
with, written afresh in plain PyTorch (any dtype, any device) from the
published equations. Nothing here imports the program.
"""
