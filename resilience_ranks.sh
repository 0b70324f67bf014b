# four ranks of recipe 2 (DDP) under the recovery plane, one process a rank:
# control, preempt (sigterm@9 -> the collective decision), --resume latest,
# and a collective rollback; each rank's exit code printed
# usage: bash resilience_ranks.sh "<model flags>" [--device cpu]
set -u
export PYTHONPATH=$PWD OMP_NUM_THREADS=${OMP_NUM_THREADS:-4}
M="$1"; shift
W=build/ddp4; rm -rf $W; mkdir -p $W
run() {  # run <label> <dir> <flags...>: the four ranks, their exit codes
  local label=$1 dir=$2; shift 2
  mkdir -p $W/$dir
  local port=$((29500 + RANDOM % 1000)) pids=() codes=()
  local t0=$(date +%s.%N)
  for r in 0 1 2 3; do
    (cd $W/$dir && RANK=$r LOCAL_RANK=$r WORLD_SIZE=4 MASTER_ADDR=localhost MASTER_PORT=$port \
      python -m tpukit_torch.recipes.ddp $M --heartbeat_dir hb "$@" > rank$r.log 2>&1) &
    pids+=($!)
  done
  for p in "${pids[@]}"; do wait $p; codes+=($?); done
  local t1=$(date +%s.%N)
  echo "== $label: exit codes ${codes[*]}, wall $(python3 -c "print(round($t1 - $t0, 2))") s"
  grep -h "training\|rollback\|preempted\|Preempted\|sentinel\|resumed\|throughput" $W/$dir/rank0.log
  grep -h "Preempted\|Error\|error" $W/$dir/rank[123].log | head -6
}
run control a "$@"
run preempt b "$@" --chaos_spec sigterm@9
cat $W/b/hb/preempt-decision.json; echo
ls $W/b/hb $W/b/checkpoints | tr '\n' ' '; echo
run resume b "$@" --resume latest
run rollback c "$@" --checkpoint_every 8 --chaos_spec nan_loss@20 --spike_threshold 6 --on_anomaly rollback
ls $W/c/hb $W/c/checkpoints | tr '\n' ' '; echo
cat $W/c/hb/rollback-0001.json; echo
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>/dev/null
rm -rf $W
