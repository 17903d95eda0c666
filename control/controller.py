#!/usr/bin/env python
"""Subtraction control daemon (reference: nersc/controller.py).

Long-running loop: query the DB for unprocessed science images (anti-join
against existing subtractions and FailedSubtraction), chunk them into jobs
of JOB_SIZE, launch workers, and track Job rows. Job launch is pluggable:
slurm (sbatch + squeue polling, the reference's Cori pattern) when
available, else a local subprocess pool — so the control plane runs
anywhere the accelerator host does.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time

JOB_SIZE = 64 * 15          # images per job (reference: controller.py:21)
POLL_S = 30


def unprocessed_pairs(session):
    """(sci_basename, ref_basename) pairs needing subtraction
    (anti-join; reference controller.py:239-274)."""
    rows = session.execute(
        'SELECT s.basename, r.basename FROM ztffiles s '
        'JOIN ztffiles r ON r.type = "ref" AND r.field = s.field AND '
        ' r.ccdid = s.ccdid AND r.qid = s.qid AND r.fid = s.fid '
        'WHERE s.type = "sci" '
        'AND NOT EXISTS (SELECT 1 FROM ztffiles z WHERE z.type = "sesub" '
        '  AND z.target_id = s.id AND z.reference_id = r.id) '
        'AND NOT EXISTS (SELECT 1 FROM failedsubtractions f WHERE '
        '  f.target_image_id = s.id AND f.reference_image_id = r.id)'
    ).fetchall()
    return [(r[0], r[1]) for r in rows]


class LocalLauncher:
    """Run worker jobs as local subprocesses (one at a time per slot)."""

    def __init__(self, workers=1):
        self.procs = {}

    def submit(self, worklist_path, script='scripts/donightly.py'):
        p = subprocess.Popen([sys.executable, script, worklist_path])
        self.procs[str(p.pid)] = p
        return str(p.pid)

    def status(self, job_id):
        p = self.procs.get(job_id)
        if p is None:
            return 'done'
        rc = p.poll()
        if rc is None:
            return 'running'
        return 'done' if rc == 0 else 'error'


class SlurmLauncher:
    """sbatch submission + squeue polling (reference controller.py:88-104,
    217-237)."""

    def __init__(self, nodes=1, ntasks=64, walltime='00:60:00',
                 queue='realtime'):
        self.nodes = nodes
        self.ntasks = ntasks
        self.walltime = walltime
        self.queue = queue

    @staticmethod
    def available():
        return shutil.which('sbatch') is not None

    def submit(self, worklist_path, script='scripts/donightly.py'):
        batch = f"""#!/bin/bash
#SBATCH -N {self.nodes}
#SBATCH -q {self.queue}
#SBATCH -t {self.walltime}
#SBATCH -o {worklist_path}.out
srun -n {self.ntasks} -c1 {sys.executable} {script} {worklist_path}
"""
        with tempfile.NamedTemporaryFile('w', suffix='.sh',
                                         delete=False) as f:
            f.write(batch)
            path = f.name
        out = subprocess.run(['sbatch', path], capture_output=True,
                             text=True, check=True)
        return out.stdout.strip().split()[-1]

    def status(self, job_id):
        out = subprocess.run(['squeue', '-j', job_id, '-h', '-o', '%T'],
                             capture_output=True, text=True)
        state = out.stdout.strip()
        if not state:
            return 'done'   # vanished from squeue => finished
        if state in ('PENDING', 'CONFIGURING'):
            return 'queued'
        if state == 'RUNNING':
            return 'running'
        return state.lower()


def run_once(session, launcher, workdir):
    """One control iteration: chunk unprocessed work + submit."""
    from zuds_tpu.bookkeeping import Job
    pairs = unprocessed_pairs(session)
    submitted = []
    for i in range(0, len(pairs), JOB_SIZE):
        chunk = pairs[i:i + JOB_SIZE]
        path = os.path.join(workdir, f'work_{int(time.time())}_{i}.txt')
        with open(path, 'w') as f:
            for sci, ref in chunk:
                f.write(f'{sci} {ref}\n')
        job_id = launcher.submit(path)
        job = Job(slurm_id=job_id, status='submitted')
        session.add(job)
        session.commit()
        submitted.append(job)
        print(f'submitted job {job_id} with {len(chunk)} images', flush=True)
    return submitted


def refresh_job_status(session, launcher):
    from zuds_tpu.bookkeeping import Job
    jobs = session.query(Job).filter(
        'status IN ("submitted", "queued", "running")').all()
    for job in jobs:
        job.status = launcher.status(job.slurm_id)
        session.add(job)
    session.commit()
    return jobs


def main(workdir='/tmp/zuds-tpu-work', once=False):
    import zuds_tpu
    zuds_tpu.init_db()
    from zuds_tpu.core import DBSession
    os.makedirs(workdir, exist_ok=True)
    launcher = SlurmLauncher() if SlurmLauncher.available() \
        else LocalLauncher()
    while True:
        sess = DBSession()
        refresh_job_status(sess, launcher)
        run_once(sess, launcher, workdir)
        if once:
            break
        time.sleep(POLL_S)


if __name__ == '__main__':
    main(once='--once' in sys.argv)
