mkdir -p chiprun_out
python tools/kernel_ab.py --phases sweep,step,routes --configs 4x128w4s1,2x256w4s1,2x256w4s2,1x512w4s1,1x1024w8s1,4x256w8s1 > chiprun_out/ab_B.txt 2>&1
echo AB_EXIT $?
python chip_smoke.py > chiprun_out/smoke_B.txt 2> chiprun_out/smoke_B.err
echo SMOKE_EXIT $?
python bench.py > chiprun_out/bench_B.txt 2> chiprun_out/bench_B.err
echo BENCH_EXIT $?
